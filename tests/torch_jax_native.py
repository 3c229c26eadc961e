"""The ``jax_native`` fixture: the JAX package's host library
(``nanoreviser_tpu.native``), loaded from a complete file.

The JAX package builds ``libnanorev.so`` lazily and in place, so a test
worker that loads it while another writes it fails, and its loader gives up
for the life of the process. A test module that compares against the JAX
package's native code imports the fixture with
``from tests.torch_jax_native import jax_native``.
"""

import subprocess

import pytest


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """Unless this process's loader already holds the library, compiles
    ``nanorev.cpp`` with the JAX package's own flags into a private
    directory (the same bytes as its in-place build), points the loader at
    it and clears its state. Yields the loader's module and restores its
    state at the end."""
    import nanoreviser_tpu.native as jnative
    import nanoreviser_tpu.native.build as jbuild

    saved = (jnative.LIB_PATH, jnative._LIB, jnative._TRIED, jnative._HDF5_OK)
    if jnative._LIB is None:
        lib = tmp_path_factory.mktemp("jax_native") / "libnanorev.so"
        subprocess.run(["g++", *jbuild.CXXFLAGS, jbuild.SRC, "-o", str(lib)],
                       check=True, capture_output=True, text=True)
        jnative.LIB_PATH = str(lib)
        jnative._LIB, jnative._TRIED, jnative._HDF5_OK = None, False, None
    if not jnative.available():
        pytest.fail("the JAX package's host library is unavailable "
                    f"(library {jnative.LIB_PATH})")
    yield jnative
    jnative.LIB_PATH, jnative._LIB, jnative._TRIED, jnative._HDF5_OK = saved
