"""The JAX references of the port's parity tests, traced with the JAX
package's Cholesky and triangular solves on their library route.

``svae_tpu.utils.smallchol`` unrolls them into scalar algebra up to
``CHOL_UNROLL_MAX`` (read when a function is traced); at the tests' small
sizes the unrolled graphs are most of a reference's trace and compile,
and the library route computes the same float64 values to rounding. A
test module takes the route for its own references by importing
``jax_library_cholesky``, an autouse module fixture that restores the
bound when the module ends. JAX's caches are cleared on entry and after
the bound is restored, so that no trace made under one route serves a
function traced under the other, in this module or in a later one run by
the same process.
"""

import contextlib

import jax
import pytest

from svae_tpu.utils import smallchol


@contextlib.contextmanager
def library_cholesky():
    unroll = smallchol.CHOL_UNROLL_MAX
    jax.clear_caches()
    smallchol.CHOL_UNROLL_MAX = 0
    try:
        yield
    finally:
        smallchol.CHOL_UNROLL_MAX = unroll
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def jax_library_cholesky():
    with library_cholesky():
        yield
