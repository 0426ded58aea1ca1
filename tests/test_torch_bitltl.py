"""The port's bit-sliced Larger-than-Life engine and kernel K3's plain
version against the JAX package, bit for bit, on the CPU.

Inputs are made with numpy from a seed and handed to both packages as
uint32 words (``interop``).  The multi-generation cases run the reference
TPU kernel ``pallas_ltl_step`` in Pallas interpret mode with forced small
blocks, as the JAX package's own tests do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.ops import bitltl as jltl
from mpi_tpu.ops.pallas_bitltl import max_gens as jax_max_gens
from mpi_tpu.ops.pallas_bitltl import pallas_ltl_step
from mpi_tpu_torch import interop
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.models.rules import Rule, rule_from_name
from mpi_tpu_torch.ops import bitlife as tbit
from mpi_tpu_torch.ops import bitltl as tltl
from mpi_tpu_torch.ops.cuda_bitltl import (
    cuda_ltl_step, ltl_step_plain, max_gens, refusal, supports,
)
from mpi_tpu_torch.ops.ltl_codegen import evaluate, rule_program

R2 = "R2,B10-13,S8-12"
R3 = "R3,B20-25,S18-30"
R4 = "R4,B30-40,S25-50"
R6 = "R6,B50-70,S40-90"
R7 = "R7,B80-100,S75-119"
RULES = ["bosco", R2, R3, R4, R6, R7, "life", "R4,B0-3+40,S1-80",
         "R3,B1+3+5+7+9+11+13+15,S2+4+6+8+10+12+14"]


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


def _planes(values, nplanes):
    """Small ints as bit planes over one row of 64 one-bit 'words'."""
    return [torch.from_numpy(((values >> k) & 1).astype(np.int32))
            for k in range(nplanes)]


def _value(planes):
    return sum(p.numpy().astype(np.int64) << k for k, p in enumerate(planes)
               if p is not None)


def test_bs_add_sum_and_ge_against_ints():
    rng = np.random.default_rng(7)
    nums = [rng.integers(0, 16, size=64, dtype=np.int64) for _ in range(11)]
    a, b = nums[0] * 7, nums[1] * 7
    s = tltl.bs_add(_planes(a, 7), _planes(b, 7))
    np.testing.assert_array_equal(_value(s), a + b)
    total = tltl.bs_sum([_planes(n, 4) for n in nums])
    np.testing.assert_array_equal(_value(total), sum(nums))
    zero = torch.zeros(64, dtype=torch.int32)
    for t in (0, 1, 63, 120, 165, 200, 255, 256, 300):
        m = tltl.bs_ge(s, t, zero).numpy()
        np.testing.assert_array_equal(m != 0, (a + b) >= t, err_msg=f"t={t}")
    # a None plane is the constant 0 plane
    assert _value(tltl.bs_sum([[None, s[0]], [s[0]]]))[0] == \
        3 * (s[0].numpy()[0] & 1)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_ltl_step_matches_jax(rule, boundary):
    # one word per row, and H below the neighbourhood (periodic rows wrap
    # more than once, as the reference's rolls do)
    for i, shape in enumerate([(20, 3), (3, 1), (1, 1), (40, 2)]):
        w = _words(shape, i)
        want = np.asarray(jltl.ltl_step(jnp.asarray(w),
                                        jax_rule_from_name(rule), boundary))
        got = tltl.ltl_step(interop.grid_from_numpy(w, "cpu"),
                            rule_from_name(rule), boundary)
        np.testing.assert_array_equal(interop.grid_to_numpy(got), want,
                                      err_msg=f"{rule} {boundary} {shape}")


def test_ltl_step_in_row_blocks_matches_one_block(monkeypatch):
    w = interop.grid_from_numpy(_words((37, 4), 9), "cpu")
    bosco = rule_from_name("bosco")
    for boundary in ("periodic", "dead"):
        whole = tltl.ltl_step(w, bosco, boundary)
        monkeypatch.setattr(tltl, "_BLOCK_WORDS", 4 * 5)  # 5 rows a block
        np.testing.assert_array_equal(tltl.ltl_step(w, bosco, boundary), whole)
        monkeypatch.undo()
    g = tbit.unpack(w).numpy()
    np.testing.assert_array_equal(
        tbit.unpack(tltl.make_ltl_stepper(bosco, "dead")(w, 2)).numpy(),
        evolve_np(g, 2, bosco, "dead"))


@pytest.mark.parametrize("rule,gens", [
    (R2, 1), (R2, 4), (R3, 2), (R4, 2), ("bosco", 1), (R6, 1), (R7, 1),
], ids=lambda v: str(v).split(",")[0])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_plain_multi_gen_matches_pallas_interpret(rule, gens, boundary):
    # (16, 128) words: the reference kernel needs 128-word rows; blocks
    # (16, 8) as the reference's own tests force them
    assert gens <= jax_max_gens(rule_from_name(rule).radius)
    w = _words((16, 128), gens)
    want = np.asarray(pallas_ltl_step(
        jnp.asarray(w), jax_rule_from_name(rule), boundary, interpret=True,
        blocks=(16, 8), gens=gens))
    got = ltl_step_plain(interop.grid_from_numpy(w, "cpu"),
                         rule_from_name(rule), boundary, gens)
    np.testing.assert_array_equal(interop.grid_to_numpy(got), want)


def test_max_gens_matches_the_reference():
    for r in range(1, 8):
        assert max_gens(r) == jax_max_gens(r)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    w = interop.grid_from_numpy(_words((10, 2), 4), "cpu")
    r2 = rule_from_name(R2)
    for gens in (1, 4):
        want = ltl_step_plain(w, r2, "dead", gens)
        assert torch.equal(cuda_ltl_step(w, r2, "dead", gens), want)
        out = torch.empty_like(w)
        assert cuda_ltl_step(w, r2, "dead", gens, out=out) is out
        assert torch.equal(out, want)
    assert cuda_ltl_step.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((4, 2), dtype=torch.int32)
    r2, bosco = rule_from_name(R2), rule_from_name("bosco")
    b0 = Rule("b0", frozenset({0}), frozenset(), radius=2)
    with pytest.raises(ValueError, match="birth-on-0"):
        cuda_ltl_step(w, b0, "periodic", gens=2)
    cuda_ltl_step(w, b0, "periodic", gens=1)  # one generation is fine
    with pytest.raises(ValueError, match="gens must be in 1..4"):
        cuda_ltl_step(w, r2, gens=5)
    with pytest.raises(ValueError, match="gens must be in 1..1"):
        cuda_ltl_step(w, bosco, gens=2)
    with pytest.raises(ValueError, match="radius 2..7"):
        cuda_ltl_step(w, rule_from_name("life"))
    with pytest.raises(TypeError):
        cuda_ltl_step(w.to(torch.int64), r2)
    with pytest.raises(ValueError, match="in place"):
        cuda_ltl_step(w, r2, out=w)
    rows = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="in place"):
        cuda_ltl_step(rows[:4], r2, out=rows[2:6])
    cuda_ltl_step(rows[:4], r2, out=rows[4:])
    with pytest.raises(ValueError):
        cuda_ltl_step(w, r2, boundary="mirror")
    assert supports((1, 32), bosco) and not supports((1, 48), bosco)
    assert supports((3, 64), r2, 4) and not supports((3, 64), r2, 5)
    assert refusal((0, 64), r2) and "birth-on-0" in refusal((7, 64), b0, 2)


def test_compiled_rule_tests_survival_shifted_by_one():
    # the kernel's rule sees the total with the centre; a live cell with
    # total t has t - 1 neighbours
    rule = rule_from_name("R2,B3-4+9,S0+7-8")
    prog = rule_program(rule)
    tot = np.arange(26, dtype=np.uint32)
    planes = [np.where((tot >> k) & 1, np.uint32(0xFFFFFFFF), np.uint32(0))
              .astype(np.uint32) for k in range(len(prog.inputs) - 1)]
    born = evaluate(prog, planes, np.zeros_like(tot))
    stay = evaluate(prog, planes, np.full_like(tot, 0xFFFFFFFF))
    assert np.flatnonzero(born).tolist() == [3, 4, 9]
    assert np.flatnonzero(stay).tolist() == [1, 8, 9]


def test_ltl_word_ops_counts_the_compiled_form():
    # the mapped cover lands within two instructions of the exact cover
    # on the radius-1 rules, whose graphs are small enough for the latter
    for name in ("life", "highlife", "daynight", "seeds", "B36/S125"):
        graph = []
        up, mid, down = (tbit._Node(graph) for _ in range(3))
        f0, f1, c0, c1 = tbit.column_sums(up, mid, down)
        L0, L1, R0, R1 = (tbit._Node(graph, (f,), shift=True)
                          for f in (f0, f1, f0, f1))
        s0, ca = tbit.low_bits(L0, c0, R0)
        root = tbit.compile_rule(L1, c1, R1, ca, s0, mid,
                                 rule_from_name(name), -1, lambda: -1)
        exact = tbit._cover(root)
        assert exact <= tbit._map_cover(root) <= exact + 2, name
    assert tltl.ltl_word_ops(rule_from_name("bosco")) == 171
    assert tltl.ltl_word_ops(rule_from_name(R2)) == 61
    assert tltl.ltl_word_ops(rule_from_name(R7)) > \
        tltl.ltl_word_ops(rule_from_name("bosco"))


@pytest.mark.parametrize("rule,lower", [(R2, 5), ("bosco", 7)])
def test_ltl_word_ops_lower_brackets_the_compiled_form(rule, lower):
    # every vertical-sum plane of both neighbouring words and every row
    # word at the cell's column reach the next state; Bosco's 11 rows give
    # way to a sliding sum's 4 planes + 3 rows
    rule = rule_from_name(rule)
    r, planes = rule.radius, {2: 3, 5: 4}[rule.radius]
    own = min(2 * r + 1, planes + 3)
    assert lower == -(-(2 * planes + own - 1) // 2)
    assert tltl.ltl_word_ops_lower(rule) == lower
    assert tltl.ltl_word_ops_lower(rule, seed=7) == lower
    assert lower < tltl.ltl_word_ops(rule)
