"""A step run as one CUDA-graph replay: the port's counterpart of ``jax.jit``.

``dirt_tpu`` runs each step as one compiled program: ``jax.jit`` of the
raster op (``dirt_tpu/rasterise_ops.py``), of the bench's gradient step
inside ``utils/benchtime.py``'s device-side loop, of the flagship loss and
train step (``__graft_entry__.py``) and of demo 5's ``lax.scan`` over its
Adam steps. PyTorch dispatches every kernel from Python instead, one to
three thousand a fwd+bwd step here, and the host sets the pace.
:class:`GraphedStep` captures one call of a step in a CUDA graph and then
replays it: the same kernels in the same order, launched by the card from
one host call.

Like ``jax.jit`` with static shapes, a graph holds one signature: the
shapes, dtypes and devices of the tensor arguments and the values of the
others, which the graph bakes in as ``jax.jit`` does its static arguments.
A new signature captures a new graph. Everything that decides a shape on
the host (``suggest_raster_config``'s counting, the config's caps) must run
before the step, as ``dirt_tpu``'s ``honest_config`` runs before its jit.
"""

from __future__ import annotations

import torch

# Calls of the step on a side stream before its capture: the first builds
# the kernels (``ops._build``), loads them and makes an optimiser's state,
# the second runs as every later call will; the allocator is warm after
# both.
WARMUP = 2


def value_and_grad(fn):
    """``fn``'s value and its gradients to every argument:
    ``step(*args) -> (value, *grads)``, the counterpart of
    ``jax.value_and_grad`` over all arguments. ``fn`` returns a scalar
    tensor; the value comes back detached."""
    def step(*args):
        leaves = [arg.detach().requires_grad_() for arg in args]
        value = fn(*leaves)
        return (value.detach(),
                *torch.autograd.grad(value, leaves))

    return step


def _on_card(args):
    return any(isinstance(arg, torch.Tensor) and arg.is_cuda for arg in args)


def _signature(args):
    return tuple(
        (tuple(arg.shape), arg.dtype, arg.device, arg.requires_grad)
        if isinstance(arg, torch.Tensor) else ("static", arg)
        for arg in args)


class _Graph:
    """One captured call: its static inputs, the graph and its outputs."""

    def __init__(self, fn, args):
        self.inputs = [
            arg.detach().clone().requires_grad_(arg.requires_grad)
            if isinstance(arg, torch.Tensor) else arg for arg in args]
        device = next(arg.device for arg in args
                      if isinstance(arg, torch.Tensor) and arg.is_cuda)
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            # Gradients the warm-up calls left on the inputs: the graph's
            # backward must make its own, not add to these.
            for static in self.inputs:
                if isinstance(static, torch.Tensor):
                    static.grad = None
            self.graph = torch.cuda.CUDAGraph()
            # A private memory pool; torch.cuda.graph raises if the
            # capture fails, and nothing here catches it.
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)

    def __call__(self, args):
        with torch.no_grad():
            for static, arg in zip(self.inputs, args):
                if isinstance(arg, torch.Tensor) and arg is not static:
                    static.copy_(arg)
        self.graph.replay()
        return self.outputs


class GraphedStep:
    """``fn`` run as a CUDA-graph replay, one graph per signature.

    ``fn(*args)`` takes tensors and hashable Python values and returns a
    tensor or a tuple of tensors; it may also update state it closes over,
    such as an optimiser's parameters (``torch.optim`` with
    ``capturable=True``). Parameters whose ``.grad`` the step's
    ``backward()`` makes should start each call with ``.grad`` set to
    ``None`` (``zero_grad(set_to_none=True)`` inside ``fn``), so that the
    graph owns them.

    On CUDA tensors, the first call of a signature copies the arguments
    into static buffers, runs ``fn`` ``WARMUP`` times on a side stream and
    captures one call with ``torch.cuda.graph`` in a private memory pool
    (the forward, the loss, ``backward()`` and an optimiser step, where
    ``fn`` takes one). The warm-up calls run ``fn`` for real, side effects
    included. Every call, the first too, copies its arguments into the
    static buffers, replays the graph and returns the tensors the captured
    call returned: the same tensors every call, which the next call of the
    same signature overwrites (clone what must outlive it). A capture that
    fails raises; nothing ever runs ``fn`` eagerly on the card in its place.

    Without a CUDA tensor among the arguments (CPU tensors, which only the
    tests pass), a call is ``fn(*args)``: there is no graph there, as the
    kernels' plain versions stand in for the kernels.

    ``example_args`` with a CUDA tensor among them captures their
    signature at construction (warm-up calls included), so that a caller
    can time the capture apart from the replays, as ``dirt_tpu``'s demo 5
    compiles ahead of its loop.
    """

    def __init__(self, fn, example_args):
        self.fn = fn
        self.graphs = {}
        if _on_card(example_args):
            self._graph(example_args)

    def _graph(self, args):
        key = _signature(args)
        if key not in self.graphs:
            self.graphs[key] = _Graph(self.fn, args)
        return self.graphs[key]

    def __call__(self, *args):
        if not _on_card(args):
            return self.fn(*args)
        return self._graph(args)(args)

    def pool_bytes(self):
        """Bytes the graphs' private memory pools hold on the card: the
        segments of ``torch.cuda.memory_snapshot()`` that they own, which
        keep one call's intermediates between replays."""
        pools = {tuple(entry.graph.pool()) for entry in self.graphs.values()}
        return sum(segment["total_size"]
                   for segment in torch.cuda.memory_snapshot()
                   if tuple(segment["segment_pool_id"]) in pools)

