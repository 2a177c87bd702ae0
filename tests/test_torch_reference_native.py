"""The port's tests hold the port against the JAX package's *native* builders.

`rpt_tpu.native` compiles its C++ library on first use into one shared path
(`_librpt.so.tmp`, then `_librpt.so`) and caches a failure for the life of
the process; every tree `rpt_tpu` then builds comes from its pure-Python
median builder. Under pytest-xdist the workers import the test files at
once and several of them compile at the same moment, so a worker that loses
that race would compare the port (always the native SAH builder) against
the reference's *other* builder, whose trees differ.

`reference_native()`, called at import by every port test file that builds
or parses through `rpt_tpu`, makes each worker wait for the reference's
native library (serialised across processes by a file lock) and raises if
it never loads: no port test proceeds on the Python builder.
"""

import fcntl
import os
import tempfile
import time

import numpy as np

import rpt_tpu.native as ref_native

_WAIT_SECONDS = 60.0
_RETRY_SECONDS = 0.25


def reference_native():
    """Load `rpt_tpu`'s native library in this process, or raise. Under an
    exclusive lock on a file in the temporary directory, call its
    `get_lib()`; on a cached failure (a lost build race, or a library
    another process is still writing) clear the cache and retry for up to
    a minute."""
    lock_path = os.path.join(tempfile.gettempdir(), "rpt_tpu_reference_native.lock")
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + _WAIT_SECONDS
            while ref_native.get_lib() is None:
                if time.monotonic() > deadline:
                    raise RuntimeError("rpt_tpu's native library did not load: the port's parity tests "
                                       "need the reference's native builders")
                time.sleep(_RETRY_SECONDS)
                ref_native._tried = False
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


reference_native()


def test_reference_builds_with_its_native_library():
    """After the helper the reference's BVH build is the native SAH tree,
    the one the port's build copies, and not the median fallback."""
    from rpt_tpu.ops.bvh import LEAF_SIZE, build_bvh

    reference_native()
    assert ref_native.native_available()
    rng = np.random.default_rng(0)
    base = rng.uniform(-1.0, 1.0, (300, 1, 3))
    verts = np.concatenate([base, base + rng.uniform(-0.1, 0.1, (300, 2, 3))], axis=1).astype(np.float32)
    norms = np.repeat(np.array([[[0.0, 0.0, 1.0]]], np.float32), 3, axis=1).repeat(300, axis=0)
    bvh = build_bvh(verts, norms, np.zeros(300, np.int32))
    node_min, node_max, is_leaf, skip, leaf_start, leaf_count, perm = ref_native.build_bvh_sah(
        verts.min(axis=1), verts.max(axis=1), LEAF_SIZE)
    np.testing.assert_array_equal(np.asarray(bvh.node_min), node_min)
    np.testing.assert_array_equal(np.asarray(bvh.node_max), node_max)
    np.testing.assert_array_equal(np.asarray(bvh.skip), skip)
    np.testing.assert_array_equal(np.asarray(bvh.leaf_start), leaf_start)
    np.testing.assert_array_equal(np.asarray(bvh.leaf_count), leaf_count)
    np.testing.assert_array_equal(np.asarray(bvh.verts), verts[perm])
