"""A whole-timestep window as one CUDA graph.

The banded, lattice and cloth windows are 2 + 3 admm_iters launches a
timestep, the cloth's one more with wind (`csrc/banded_step.cu`,
`csrc/lattice_step.cu`, `csrc/cloth_step.cu`). `WindowGraphs` captures a
window's launches once for each window length and replays the graph
after, so a window is one submission to the card, as the Pallas kernel's
one launch per window is. A graph holds the addresses of the buffers it
was captured on: the caller advances its state in place, and a buffer
that has moved since (a state tensor swapped for another) makes every
window be captured anew, never replayed on stale addresses.
"""

from __future__ import annotations

import torch


class WindowGraphs:
    """The CUDA graphs of one stepper's windows.

    make(state, planes, cfg) returns the window on those tensors: an
    object with `launch(n)`, which enqueues n timesteps' launches on the
    current stream, and `ops(n)`, how many launches that is. The graphs
    key on cfg and on the addresses of every tensor of state and planes.
    `counter` is the kernel's wrapper function, whose `launches` counts the
    windows submitted and `ops` the launches they hold. `lengths`: window
    lengths captured together with the first one, so that a stepper's
    usual windows are all captured at its first step."""

    def __init__(self, make, counter, lengths=()):
        self._make, self._counter = make, counter
        self._lengths = tuple(lengths)
        self._window, self._key, self._graphs = None, None, {}

    @property
    def window(self):
        """The window the graphs were captured on (None before the first
        advance): its scratch and result buffers, which replays write."""
        return self._window

    def _capture(self, n_steps, device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph):
            self._window.launch(n_steps)
        self._graphs[n_steps] = graph

    def advance(self, state, planes, cfg, n_steps: int):
        """Advance `state` by n_steps timesteps, in place, in one graph
        replay; the graph is captured on first use."""
        key = (cfg, *(t.data_ptr() for t in (*state.values(),
                                              *planes.values())))
        device = state["x"].device
        if key != self._key:
            self._graphs = {}
            self._window = self._make(state, planes, cfg)
            self._key = key
            for n in self._lengths:
                self._capture(n, device)
        if n_steps not in self._graphs:
            self._capture(n_steps, device)
        with torch.cuda.device(device):
            self._graphs[n_steps].replay()
        self._counter.launches += 1
        if getattr(cfg, "collect", None):
            # a window in a residual mode (banded, cloth)
            self._counter.residual_launches += 1
        self._counter.ops += self._window.ops(n_steps)
