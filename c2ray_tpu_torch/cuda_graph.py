"""The device-resident loop's CUDA graph: a captured body run on the card
while a flag holds (csrc/loop_graph.cu).

WhileGraph captures a body once on a side stream into a graph it keeps
(torch.cuda.CUDAGraph(keep_graph=True)), then has the loop library wrap
it in a graph with one conditional WHILE node: a launch runs the body
again and again on the card until the body has written 0 to the
flag.  This is the counterpart of the JAX package's lax.while_loop
program; PyTorch binds no conditional node, so the outer graph is built
through the CUDA runtime.  The body's memory is the capture's own
private pool, held until close(); unlike torch.cuda.graph, the capture
empties no cache.  A failed capture, build or launch raises.
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import _build

_vp = ctypes.c_void_p
_SIGNATURES = {
    "c2r_while_graph": [_vp, _vp, ctypes.POINTER(_vp), ctypes.POINTER(_vp)],
    "c2r_while_graph_launch": [_vp, _vp],
    "c2r_graph_nodes": [_vp, ctypes.POINTER(ctypes.c_ulonglong)],
    "c2r_graph_kernel_nodes": [_vp, ctypes.POINTER(ctypes.c_ulonglong)],
    "c2r_while_graph_destroy": [_vp, _vp],
    # the loop's phase clock (ops/launches.PhaseClock)
    "c2r_phase_stamp": [_vp, _vp, _vp, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _vp, ctypes.c_int, _vp],
    "c2r_clock_anchor": [_vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, _vp],
}


def _fn(name: str):
    lib = _build.load("loop_graph")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.c2r_error_string(rc).decode()} ({rc})")


def kernel_nodes(graph: int) -> int:
    """The kernel nodes of a cudaGraph_t (CUDAGraph.raw_cuda_graph() of a
    graph kept with keep_graph=True)."""
    lib, fn = _fn("c2r_graph_kernel_nodes")
    count = ctypes.c_ulonglong(0)
    _check(lib, fn(graph, ctypes.byref(count)), "counting kernel nodes")
    return int(count.value)


class WhileGraph:
    """body() captured once; run() launches `while go: body()` on the
    current stream.  go: a one-byte (bool) CUDA tensor that body()
    rewrites, and that the caller sets before run().
    Attributes: nodes (the body graph's node count), capture_s."""

    def __init__(self, body, go: torch.Tensor):
        if go.device.type != "cuda" or go.dtype != torch.bool \
                or go.numel() != 1:
            raise ValueError("go must be a one-element bool CUDA tensor")
        self.go = go
        self._exec = self._graph = None
        t0 = time.perf_counter()
        self.body = torch.cuda.CUDAGraph(keep_graph=True)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body.capture_begin()
            try:
                body()
            finally:
                self.body.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        raw = self.body.raw_cuda_graph()
        lib, fn = _fn("c2r_graph_nodes")
        count = ctypes.c_ulonglong(0)
        _check(lib, fn(raw, ctypes.byref(count)), "counting graph nodes")
        self.nodes = int(count.value)
        lib, fn = _fn("c2r_while_graph")
        graph, exec_ = _vp(), _vp()
        _check(lib, fn(raw, go.data_ptr(), ctypes.byref(graph),
                       ctypes.byref(exec_)), "building the while graph")
        self._graph, self._exec = graph.value, exec_.value
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        lib, fn = _fn("c2r_while_graph_launch")
        _check(lib, fn(self._exec, torch.cuda.current_stream().cuda_stream),
               "launching the while graph")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass              # never raise while being collected

    def close(self) -> None:
        if self._exec is not None or self._graph is not None:
            lib, fn = _fn("c2r_while_graph_destroy")
            exec_, graph = self._exec, self._graph
            self._exec = self._graph = None
            _check(lib, fn(graph, exec_), "destroying the while graph")
        self.body.reset()
