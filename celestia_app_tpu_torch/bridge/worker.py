"""The persistent square worker behind the C bridge, on the port.

    CELESTIA_BRIDGE_DEVICE=cuda python -m celestia_app_tpu_torch.bridge.worker

Speaks the length-prefixed binary protocol of
bridge/celestia_square_bridge.cpp (the same as
celestia_app_tpu/bridge/worker.py) on stdin/stdout, so a C or Go host that
passes this argv to `cstpu_init` gets the port as its square backend:

    request:  magic "CSQ1" | op u32 | k u32 | payload_len u64 | payload
    response: magic "CSQR" | status u32 | payload_len u64 | payload
    ops: 1 extend (payload = ODS; response = EDS || 2k row roots ||
         2k column roots || data root), 2 ping, 3 warmup (the kernel build
         and one extend at k), 4 shutdown.
    status: 0 ok, 1 the op failed (its traceback goes to stderr), 2
    unknown op.  A bad magic or a truncated request ends the worker with
    exit code 1; end of input between requests, or shutdown, with 0.

`$CELESTIA_BRIDGE_DEVICE` (default "cuda") names the device, resolved by
device.resolve_device: without a card every extend and warmup answers
status 1, so `cstpu_init` with warmup sizes returns NULL.  There is no
fallback to the CPU; "cpu" runs the plain versions and is asked for by
name.  On exit the worker writes one line to stderr with its device and
its kernel launch counts.

Importing this module has no side effect: `main` makes file descriptor 1
a copy of stderr, keeping the protocol on a private duplicate, before it
imports torch or any module of the port, so nothing those print can reach
the protocol stream.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import traceback

REQ_MAGIC = 0x31515343  # "CSQ1"
RESP_MAGIC = 0x52515343  # "CSQR"
OP_EXTEND = 1
OP_PING = 2
OP_WARMUP = 3
OP_SHUTDOWN = 4

REQ_HEADER = struct.Struct("<IIIQ")
RESP_HEADER = struct.Struct("<IIQ")
SHARE_SIZE = 512


def _read_exact(stream, n: int) -> bytearray | None:
    """`n` bytes from `stream` into a writable buffer, or None at end of
    input before all of them arrived."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = stream.readinto(view[got:])
        if not r:
            return None
        got += r
    return buf


def _respond(out, status: int, parts=()) -> None:
    out.write(RESP_HEADER.pack(RESP_MAGIC, status, sum(len(p) for p in parts)))
    for p in parts:
        out.write(p)
    out.flush()


class _Backend:
    """The port's square path on the worker's device, imported on first use."""

    def __init__(self, requested: str):
        self.requested = requested
        self._device = None

    def device(self):
        if self._device is None:
            from celestia_app_tpu_torch.device import resolve_device

            self._device = resolve_device(self.requested)
        return self._device

    def extend(self, ods_bytes: bytearray, k: int) -> list:
        import numpy as np

        from celestia_app_tpu_torch.da.eds import ExtendedDataSquare

        if len(ods_bytes) != k * k * SHARE_SIZE:
            raise ValueError(f"payload of {len(ods_bytes)} bytes is not a k={k} ODS "
                             f"({k * k * SHARE_SIZE} bytes)")
        ods = np.frombuffer(ods_bytes, dtype=np.uint8).reshape(k, k, SHARE_SIZE)
        eds = ExtendedDataSquare.compute(ods, device=self.device())
        return [memoryview(eds.squared()).cast("B"), b"".join(eds.row_roots()),
                b"".join(eds.col_roots()), eds.data_root()]

    def warmup(self, k: int) -> None:
        dev = self.device()
        if dev.type == "cuda":
            from celestia_app_tpu_torch.kernels import _build

            _build.build()
        self.extend(bytearray(k * k * SHARE_SIZE), k)

    def report(self) -> str:
        """The device the worker ran on and its kernel launches."""
        name = self.requested
        launches = {}
        if self._device is not None:
            import torch

            from celestia_app_tpu_torch.kernels import _build

            if self._device.type == "cuda":
                name = torch.cuda.get_device_name(self._device)
            launches = dict(_build.LAUNCHES)
        return json.dumps({"device": name, "resolved": self._device is not None,
                           "launches": launches})


def main() -> int:
    # The protocol keeps a private copy of fd 1; fd 1 and sys.stdout become
    # stderr, so a stray print or a native library's write cannot corrupt
    # the stream the C side reads.
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    stdin = sys.stdin.buffer
    backend = _Backend(os.environ.get("CELESTIA_BRIDGE_DEVICE", "cuda"))
    reported = False
    try:
        while True:
            header = stdin.read(REQ_HEADER.size)
            if not header:
                return 0  # the parent closed the pipe
            if len(header) < REQ_HEADER.size:
                print(f"bridge worker: truncated request header ({len(header)} bytes)",
                      file=sys.stderr)
                return 1
            magic, op, k, payload_len = REQ_HEADER.unpack(header)
            if magic != REQ_MAGIC:
                print(f"bridge worker: bad request magic {magic:#010x}", file=sys.stderr)
                return 1
            payload = _read_exact(stdin, payload_len)
            if payload is None:
                print(f"bridge worker: truncated payload (want {payload_len} bytes)",
                      file=sys.stderr)
                return 1

            if op == OP_PING:
                _respond(out, 0)
            elif op in (OP_EXTEND, OP_WARMUP):
                try:
                    if op == OP_EXTEND:
                        parts = backend.extend(payload, k)
                    else:
                        backend.warmup(k)
                        parts = ()
                except Exception:
                    print(f"bridge worker: op {op} at k={k} failed", file=sys.stderr)
                    traceback.print_exc(file=sys.stderr)
                    _respond(out, 1)
                else:
                    _respond(out, 0, parts)
            elif op == OP_SHUTDOWN:
                # The report goes first: the C side sends SIGTERM as soon as
                # it has read this response.
                reported = _report(backend)
                _respond(out, 0)
                return 0
            else:
                print(f"bridge worker: unknown op {op}", file=sys.stderr)
                _respond(out, 2)
    finally:
        if not reported:
            _report(backend)


def _report(backend: _Backend) -> bool:
    print(f"bridge worker exit: {backend.report()}", file=sys.stderr, flush=True)
    return True


if __name__ == "__main__":
    sys.exit(main())
