"""One loop body replayed as a CUDA graph.

A fixed-shape iteration, state <- body(state), costs the host a launch
for every small kernel of the body when it runs eagerly. `GraphLoop`
captures one body once as a CUDA graph that writes a static state in
place, and replays it: the same kernels in the same order as the eager
loop, so the same values. The tracer's attempt loop (solve.trace_rhs),
the Crank-Nicolson step and the inverse iteration (fokker_planck) run
on it.
"""

import torch


def _assign(state, out):
    """Write body's output into the static state: a tensor, or a tuple of
    tensors whose unchanged fields come back as the state's own."""
    if isinstance(state, torch.Tensor):
        state.copy_(out)
        return
    for dst, src in zip(state, out):
        if src is not dst:
            dst.copy_(src)


class GraphLoop:
    """state <- body(state) on one static state (a tensor or a tuple of
    tensors, updated in place). On the card with graph=True one body is
    captured as a CUDA graph, after a warm-up on a side stream whose
    result is discarded, and replayed; else the body runs eagerly.
    run(k) applies it k times."""

    def __init__(self, body, state, graph=True):
        self.body, self.state = body, state
        dev = (state if isinstance(state, torch.Tensor) else state[0]).device
        self.graph = None
        if graph and dev.type == "cuda":
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body(state)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                _assign(state, body(state))

    def run(self, k, until=None, check_every=1):
        """Apply the body k times and return the state. until(state) -> a
        bool tensor: checked before every check_every-th pass, the loop
        leaves once it is true (one host sync a check)."""
        for i in range(k):
            if until is not None and i % check_every == 0 and bool(
                    until(self.state)):
                break
            if self.graph is not None:
                self.graph.replay()
            else:
                _assign(self.state, self.body(self.state))
        return self.state
