"""tests/test_torch_schur_compiled.py's case with the iterative A11
solve (Jacobi-BiCGStab, one host step per solve in a recorded
iteration): ``solve(compiled=True)`` of both packages on
examples/distributed_schur.py's n = 240 DAE, the same iterations and
status, V T V' within 1e-6 (that file says why).  A file of its own: it
is the slowest case on the CPU, and the suite's workers take a file
each."""

import pytest

from test_torch_parity import jax_sign_fixed  # noqa: F401  (fixture)
from test_torch_schur_compiled import (  # noqa: F401  (fixture)
    compiled_matches_jax, one_blas_thread)


def test_compiled_matches_jax_iterative(jax_sign_fixed):
    compiled_matches_jax("iterative", None)
