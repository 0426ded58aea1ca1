"""The port's dense stencil engine and kernel K2's plain version against the
JAX package, bit for bit, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
multi-generation cases run the reference TPU kernel ``pallas_step`` in
Pallas interpret mode, as the JAX package's own tests do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.ops import stencil as jst
from mpi_tpu.ops.pallas_stencil import pallas_step
from mpi_tpu_torch import interop
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.models.rules import Rule, rule_from_name
from mpi_tpu_torch.ops import stencil as tst
from mpi_tpu_torch.ops.cuda_stencil import (
    cuda_dense_step, dense_step_plain, refusal, rule_table, supports,
)

RULES = ["life", "daynight", "B0/S8", "R2,B10-13,S8-12", "bosco",
         "R3,B20-25,S18-30", "R7,B80-100,S75-119", "R4,B1+5+9-12+40,S0-3+70"]


def _cells(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape,
                                                dtype=np.uint8)


def _jax_rule(rule):
    return jax_rule_from_name(rule) if isinstance(rule, str) else rule


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_step_matches_jax_and_the_oracle(rule, boundary):
    # (3, 4) and (1, 1) are smaller than every neighbourhood here: periodic
    # counts take wrapped cells more than once, as numpy's wrap pad does
    for i, shape in enumerate([(20, 23), (3, 4), (1, 1), (17, 130)]):
        g = _cells(shape, i)
        want = np.asarray(jst.step(jnp.asarray(g), jax_rule_from_name(rule),
                                   boundary))
        got = tst.step(torch.from_numpy(g), rule_from_name(rule), boundary)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{rule} {boundary} {shape}")
        np.testing.assert_array_equal(
            got.numpy(), evolve_np(g, 1, rule_from_name(rule), boundary))


@pytest.mark.parametrize("radius", [1, 3, 7])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_pad_and_counts_match_jax(radius, boundary):
    for shape in [(9, 14), (2, 5)]:
        g = _cells(shape, radius)
        p = tst.pad_grid(torch.from_numpy(g), radius, boundary)
        np.testing.assert_array_equal(
            p.numpy(), np.asarray(jst.pad_grid(jnp.asarray(g), radius,
                                               boundary)))
        np.testing.assert_array_equal(
            tst.counts_from_padded(p, radius).numpy(),
            np.asarray(jst.neighbor_counts(jnp.asarray(g), radius, boundary)))
    with pytest.raises(ValueError):
        tst.pad_grid(torch.zeros((2, 2), dtype=torch.uint8), 1, "mirror")


def test_stepper_matches_jax_stepper():
    g = _cells((24, 40), 5)
    want = np.asarray(jst.make_stepper(jax_rule_from_name("bosco"), "dead")(
        jnp.asarray(g), 3))
    got = tst.make_stepper(rule_from_name("bosco"), "dead")(
        torch.from_numpy(g), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rule,gens", [
    ("life", 1), ("life", 3), ("life", 16),
    ("R2,B10-13,S8-12", 1), ("R2,B10-13,S8-12", 3), ("R2,B10-13,S8-12", 8),
    ("bosco", 1), ("bosco", 3),
], ids=lambda v: str(v).split(",")[0])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_plain_multi_gen_matches_pallas_interpret(rule, gens, boundary):
    # (32, 128): the reference kernel needs 128-cell rows; gens x r > 8
    # takes its 16-row halo slab
    g = _cells((32, 128), gens)
    want = np.asarray(pallas_step(jnp.asarray(g), jax_rule_from_name(rule),
                                  boundary, interpret=True, gens=gens))
    got = dense_step_plain(interop.dense_from_numpy(g, "cpu"),
                           rule_from_name(rule), boundary, gens)
    np.testing.assert_array_equal(interop.dense_to_numpy(got), want)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    g = torch.from_numpy(_cells((13, 50), 2))
    bosco = rule_from_name("bosco")
    for gens in (1, 3):
        want = dense_step_plain(g, bosco, "dead", gens)
        assert torch.equal(cuda_dense_step(g, bosco, "dead", gens), want)
        out = torch.empty_like(g)
        assert cuda_dense_step(g, bosco, "dead", gens, out=out) is out
        assert torch.equal(out, want)
    assert cuda_dense_step.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros((4, 6), dtype=torch.uint8)
    b0 = Rule("b0", frozenset({0}), frozenset(), radius=2)
    with pytest.raises(ValueError, match="birth-on-0"):
        cuda_dense_step(g, b0, "periodic", gens=2)
    cuda_dense_step(g, b0, "periodic", gens=1)  # one generation is fine
    bosco = rule_from_name("bosco")
    with pytest.raises(ValueError, match="gens x radius"):
        cuda_dense_step(g, bosco, gens=4)       # 20 cells of halo
    cuda_dense_step(g, bosco, gens=3)
    with pytest.raises(ValueError):
        cuda_dense_step(g, gens=0)
    with pytest.raises(TypeError):
        cuda_dense_step(g.to(torch.int32))
    with pytest.raises(ValueError, match="in place"):
        cuda_dense_step(g, out=g)
    rows = torch.zeros((8, 6), dtype=torch.uint8)
    with pytest.raises(ValueError, match="in place"):
        cuda_dense_step(rows[:4], out=rows[2:6])
    cuda_dense_step(rows[:4], out=rows[4:])
    with pytest.raises(ValueError):
        cuda_dense_step(g, boundary="mirror")
    assert supports((1, 1), bosco, 3) and not supports((1, 1), bosco, 4)
    assert supports((7, 65), rule_from_name("life"), 16)
    assert "birth-on-0" in refusal((7, 64), b0, 2)
    assert refusal((0, 64), bosco) and refusal((7, 64), bosco, 1, "mirror")


def test_rule_table_holds_every_count():
    rule = rule_from_name("R7,B0+31+32+224,S1-3+200-224")
    words = list(rule_table(rule))
    bits = [(words[c // 32] >> (c % 32)) & 1 for c in range(256)]
    keep = [(words[8 + c // 32] >> (c % 32)) & 1 for c in range(256)]
    assert [c for c in range(256) if bits[c]] == [0, 31, 32, 224]
    assert [c for c in range(256) if keep[c]] == \
        [1, 2, 3] + list(range(200, 225))
    assert rule.birth_intervals == ((0, 0), (31, 32), (224, 224))
