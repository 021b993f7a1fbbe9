"""The decode step as a CUDA graph: the port's counterpart of the
reference's compiled decode (``repro/serving/engine.py`` jits the decode
loop as one ``lax.scan``, ``repro/serving/scheduler.py`` jits the
continuous engine's lock-step ``step``).

``CapturedStep(fn, device)`` takes ``fn``, one step that reads and writes,
in place, only tensors that outlive it (its input and output buffers, the
KV cache). It runs ``fn`` ``WARMUP`` times on a stream of its own, so that
everything a step makes at first use is made there, outside the capture:
the kernel library, the RoPE frequencies, the split kernels' per-stream
merge counters and workspace (zeroed there, so no memset is captured).
Then it captures one call of ``fn`` into a ``torch.cuda.CUDAGraph`` with a
private memory pool, and ``replay()`` launches the whole step with one
``cudaGraphLaunch``: the same kernels on the same buffers, without the
~2,300 launches from Python of the eager step. The warm-up runs the step
for real, so callers capture on state that they reset afterwards.

A capture that meets a host synchronisation or a host-to-device copy
raises; there is no eager fallback. The wrappers' launch counts recorded
during the capture are added to ``_lib.LAUNCHES`` at every replay
(``_lib.replayed``).
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import w8a8_matmul as W8

WARMUP = 2


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph (kernels, memsets, copies), from the
    driver."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


class CapturedStep:
    """One step function captured as a CUDA graph on ``device``.

    ``launches``: the kernel launches of one replay, by wrapper name;
    ``n_nodes``: the graph's nodes; ``capture_s``: host seconds of the
    warm-up, the capture and the instantiation."""

    def __init__(self, fn: Callable[[], None], device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures work on the card, not "
                             f"on {device}")
        t0 = time.perf_counter()
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP):
                fn()
        torch.cuda.current_stream(device).wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

        def capture():
            with torch.cuda.graph(self.graph, stream=self.stream):
                fn()

        self.launches = _lib.record_launches(capture)
        self.n_nodes = _node_count(self.graph)
        self.graph.instantiate()
        # the per-stream buffers the captured kernels address stay alive
        # with the graph, even if a later call on this stream grows them
        key = (device, self.stream.cuda_stream)
        self.workspaces = [d[key] for d in (FD.TICKETS, W8.WORKSPACE)
                           if key in d]
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        _lib.replayed(self.launches)
