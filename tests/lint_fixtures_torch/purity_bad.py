"""Known-bad traced-purity cases: impure code reached from a rule
header, or from the function that hashes one into a kernel library's
key.  A value read there is baked into a cached library (or changes its
key on every process).  Flagged lines carry ``# expect: traced-purity``."""

import hashlib
import random
import time

import numpy as np


def _stamp():
    return time.time()                      # expect: traced-purity


def _gates(rule, seen=[]):                  # expect: traced-purity
    seen.append(rule)
    return f"// {len(seen)} rules so far"


def rule_header(rule):
    salt = random.random()                  # expect: traced-purity
    lines = [f"// {rule}: built at {_stamp()}", _gates(rule)]
    print("emitting", rule)                 # expect: traced-purity
    return "\n".join(lines) + f"// {salt}"


def _rule_parts(kernel, rule):
    h = hashlib.sha256(kernel.encode())
    h.update(rule_header(rule).encode())
    h.update(np.random.bytes(4))            # expect: traced-purity
    return h.hexdigest()[:16]


def elsewhere():
    """Not reached from a root: free to read the clock."""
    return time.time()
