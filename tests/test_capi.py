"""Native C API tests: ctypes attach (in-process) and standalone C host
(embedded interpreter) via subprocess."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

CAPI_DIR = os.path.join(os.path.dirname(__file__), "..", "capi")
LIB = os.path.join(CAPI_DIR, "libfabber_core_tpu.so")
HOST = os.path.join(CAPI_DIR, "test_host")


def build():
    subprocess.run(["make", "-C", CAPI_DIR, "all", "test_host"],
                   check=True, capture_output=True)


@pytest.fixture(scope="module")
def clib():
    if not os.path.exists(LIB):
        build()
    lib = ctypes.CDLL(LIB)
    lib.fabber_new.restype = ctypes.c_void_p
    lib.fabber_new.argtypes = [ctypes.c_char_p]
    lib.fabber_set_extent.argtypes = [
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p]
    lib.fabber_set_opt.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_char_p]
    lib.fabber_set_data.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint,
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p]
    lib.fabber_dorun.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                 ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_void_p]
    lib.fabber_get_data_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
    lib.fabber_get_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_char_p]
    lib.fabber_get_models.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                      ctypes.c_char_p, ctypes.c_char_p]
    lib.fabber_get_model_params.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                            ctypes.c_char_p, ctypes.c_char_p]
    lib.fabber_destroy.argtypes = [ctypes.c_void_p]
    return lib


class TestCtypesAttach:
    def test_full_run(self, clib):
        err = ctypes.create_string_buffer(256)
        fab = clib.fabber_new(err)
        assert fab, err.value

        out = ctypes.create_string_buffer(4096)
        assert clib.fabber_get_models(fab, 4096, out, err) == 0
        assert b"poly" in out.value

        nx, ny, nz, nt = 3, 3, 2, 12
        nv = nx * ny * nz
        mask = np.ones(nv, np.int32)
        mask[0] = 0
        assert clib.fabber_set_extent(
            fab, nx, ny, nz,
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), err) == 0

        for k, v in [("model", "poly"), ("degree", "1"), ("method", "vb"),
                     ("noise", "white"), ("max-iterations", "6"),
                     ("save-mean", ""), ("save-mvn", "")]:
            assert clib.fabber_set_opt(fab, k.encode(), v.encode(), err) == 0, \
                err.value

        assert clib.fabber_get_model_params(fab, 4096, out, err) == 0
        assert out.value.split() == [b"c0", b"c1"]

        t = np.arange(1, nt + 1, dtype=np.float32)
        vol = np.broadcast_to(1.0 + 0.25 * t, (nv, nt)).T.copy()  # [T,V]
        flat = vol.T.reshape(-1, order="F").astype(np.float32)
        # column-major 4D: x fastest then t -> [V major per t]
        flat = np.ascontiguousarray(
            vol.T.reshape(nx, ny, nz, nt, order="F").flatten(order="F"),
            dtype=np.float32)
        assert clib.fabber_set_data(
            fab, b"data", nt,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err) == 0

        log = ctypes.create_string_buffer(1 << 20)
        assert clib.fabber_dorun(fab, 1 << 20, log, err, None) == 0, err.value
        assert b"Duration" in log.value

        size = clib.fabber_get_data_size(fab, b"mean_c1", err)
        assert size == 1
        buf = np.zeros(nv, np.float32)
        assert clib.fabber_get_data(
            fab, b"mean_c1",
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err) == 0
        assert buf[0] == 0.0  # masked-out voxel
        np.testing.assert_allclose(buf[1:], 0.25, atol=1e-3)

        # finalMVN size: 2 model + 1 noise = 3 -> 10 rows
        assert clib.fabber_get_data_size(fab, b"finalMVN", err) == 10

        clib.fabber_destroy(fab)

    def test_error_reporting(self, clib):
        err = ctypes.create_string_buffer(256)
        fab = clib.fabber_new(err)
        # data before extent -> error with message
        data = np.zeros(4, np.float32)
        rc = clib.fabber_set_data(
            fab, b"data", 1,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err)
        assert rc < 0
        assert b"Extent" in err.value
        clib.fabber_destroy(fab)


@pytest.mark.skipif(not os.path.exists("/usr/bin/cc"), reason="no C compiler")
def test_standalone_c_host():
    """True embedding: a C binary with no Python host runs a full fit."""
    if not os.path.exists(HOST):
        build()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["FABBER_TPU_PYTHONPATH"] = (
        os.path.abspath(os.path.join(CAPI_DIR, ".."))
        + ":" + ":".join(p for p in __import__("sys").path if "site-packages" in p))
    res = subprocess.run([HOST], capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PASSED" in res.stdout
