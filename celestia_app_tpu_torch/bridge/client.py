"""ctypes consumer of the C bridge (the Go/cgo integration shape), with the
port's worker behind it (the port's copy of
celestia_app_tpu/bridge/client.py).

Loads libcelestia_square_bridge.so (bridge/celestia_square_bridge.cpp) and
drives the same C ABI a Go node would: init spawns
`python -m celestia_app_tpu_torch.bridge.worker` with warmup at the given
square sizes, extend_and_dah round-trips one square, shutdown reaps the
worker.  The worker inherits the environment ($CELESTIA_BRIDGE_DEVICE) and
the working directory, from which `-m` imports the package.  A failed call
raises: there is no other backend behind this one.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from celestia_app_tpu_torch.constants import NMT_NODE_SIZE, SHARE_SIZE

WORKER_MODULE = "celestia_app_tpu_torch.bridge.worker"


class BridgeClient:
    def __init__(self, lib_path: str, warmup_ks: list[int] | None = None):
        self._lib = ctypes.CDLL(lib_path)
        self._lib.cstpu_init.restype = ctypes.c_void_p
        self._lib.cstpu_init.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t,
        ]
        self._lib.cstpu_ping.restype = ctypes.c_int
        self._lib.cstpu_ping.argtypes = [ctypes.c_void_p]
        self._lib.cstpu_extend_and_dah.restype = ctypes.c_int
        self._lib.cstpu_extend_and_dah.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        self._lib.cstpu_shutdown.restype = None
        self._lib.cstpu_shutdown.argtypes = [ctypes.c_void_p]

        argv_list = [sys.executable.encode(), b"-m", WORKER_MODULE.encode()]
        argv = (ctypes.c_char_p * (len(argv_list) + 1))(*argv_list, None)
        ks = warmup_ks or []
        ks_arr = (ctypes.c_uint32 * len(ks))(*ks) if ks else None
        self._client = self._lib.cstpu_init(argv, ks_arr, len(ks))
        if not self._client:
            raise RuntimeError(
                "bridge init failed: the worker did not start or a warmup failed "
                "(its stderr says why)")

    def ping(self) -> bool:
        return self._lib.cstpu_ping(self._client) == 0

    def extend_and_dah(self, ods: np.ndarray):
        """(k,k,512) uint8 -> (eds, row_roots, col_roots, data_root)."""
        k = ods.shape[0]
        if ods.shape != (k, k, SHARE_SIZE):
            raise ValueError(f"ODS must be (k, k, {SHARE_SIZE}), got {ods.shape}")
        ods_flat = np.ascontiguousarray(ods, dtype=np.uint8)
        eds = np.empty((2 * k, 2 * k, SHARE_SIZE), dtype=np.uint8)
        row_roots = np.empty((2 * k, NMT_NODE_SIZE), dtype=np.uint8)
        col_roots = np.empty((2 * k, NMT_NODE_SIZE), dtype=np.uint8)
        droot = np.empty(32, dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = self._lib.cstpu_extend_and_dah(
            self._client,
            ods_flat.ctypes.data_as(u8p),
            k,
            eds.ctypes.data_as(u8p),
            row_roots.ctypes.data_as(u8p),
            col_roots.ctypes.data_as(u8p),
            droot.ctypes.data_as(u8p),
        )
        if rc != 0:
            raise RuntimeError(f"bridge extend_and_dah failed at k={k} (the worker's "
                               "stderr says why)")
        return eds, row_roots, col_roots, droot.tobytes()

    def shutdown(self) -> None:
        if self._client:
            self._lib.cstpu_shutdown(self._client)
            self._client = None
