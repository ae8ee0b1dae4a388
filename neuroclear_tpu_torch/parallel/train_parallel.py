"""Data-parallel training over several cards, the port of
``neuroclear_tpu/parallel/train_parallel.py``.

The JAX package replicates the parameters and Adam's state over a
``Mesh('data')``, shards the crop batch over it and lets the partitioner
insert the gradient all-reduce.  The port runs the PyTorch way: one process
per card under ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node N -m neuroclear_tpu_torch.train_onecube ...``), NCCL
between the cards, and the collectives written out:

  * ``maybe_initialize_distributed`` brings up ``torch.distributed`` from
    torchrun's environment (the counterpart of JAX's
    ``JAX_COORDINATOR_ADDRESS`` check) and does nothing without it; the
    world size takes the place of JAX's ``device_count``.
  * ``DataParallel(model)`` broadcasts every parameter, buffer and Adam
    state from rank 0, as ``device_put(..., replicated)`` does, and hooks
    ``reduce`` between the step's gradients and its update: one flat f32
    buffer per optimizer (G, D), the step's losses packed into G's, one
    ``all_reduce`` SUM each, then a division by the world size, so every
    rank takes the same Adam update on the mean of the ranks' gradients and
    reports the global batch's mean losses.  The nets are not wrapped in
    ``DistributedDataParallel``: the step takes its gradients with
    ``torch.autograd.grad`` through 18 discriminator applications, and
    DDP's reducer fires only on ``.backward()``.
  * Batch norm takes its statistics over the global batch, as a batch norm
    over JAX's sharded batch does (``nn/norms.py``, ``all_reduce_sum``).

Only ``all_reduce`` and ``broadcast`` are used: the two collectives gloo
also runs on CUDA tensors, so one code path serves NCCL across cards and
gloo with several ranks on one card or on the CPU (the tests).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from ..nn import norms

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def torchrun_env() -> dict | None:
    """torchrun's view of this process: {"world", "rank", "local_rank",
    "local_world"}, or None outside torchrun.  An environment that sets some
    of ``TORCHRUN_ENV`` but not all raises: it is neither a launch nor a
    single process."""
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if not present:
        return None
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun's environment is half set: {present} without {missing}; "
                           "launch with python -m torch.distributed.run, or unset them")
    world = int(os.environ["WORLD_SIZE"])
    return {"world": world, "rank": int(os.environ["RANK"]),
            "local_rank": int(os.environ["LOCAL_RANK"]),
            "local_world": int(os.environ.get("LOCAL_WORLD_SIZE", world))}


def maybe_initialize_distributed(device="cuda", backend: str | None = None) -> bool:
    """Bring up the default process group from torchrun's environment;
    without it (or with a group already up) do nothing.  ``backend``: NCCL
    when ``device`` (this rank's) is a card, gloo on the CPU; an explicit
    ``"gloo"`` runs several ranks on one card.  No fallback: a failing
    backend raises.  Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    env = torchrun_env()
    if env is None:
        return False
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://", world_size=env["world"],
                            rank=env["rank"], **kwargs)
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or a single process: the one that prints and writes."""
    return rank() == 0


def comm_device() -> torch.device:
    """Where a collective's tensors live: this rank's card under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank (``value`` itself in one process)."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device())
    dist.broadcast(t, 0)
    return int(t.item())


@contextlib.contextmanager
def rank_zero_stdout():
    """Standard output on rank 0 only; the other ranks' prints go nowhere
    (their errors still reach standard error)."""
    if is_main():
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks; its backward all-reduces the
    incoming gradient (the ``SyncBatchNorm`` arithmetic: each rank's loss
    depends on every rank's ``x`` through the sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(x)


def _broadcast_tensors(tensors) -> None:
    """Rank 0's values of ``tensors`` into every rank's, in place: one
    flat buffer per dtype, one broadcast each."""
    dev = comm_device()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1).to(dev) for t in group])
        dist.broadcast(flat, 0)
        i = 0
        for t in group:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[i:i + n].view(t.shape))
            i += n


class DataParallel:
    """Wraps a model of ``models/`` (``BaseModel``) for the world of the
    initialized process group: every rank takes its share of the global
    batch through the model's single-card step; the gradients and losses
    are averaged over the ranks before the one Adam update."""

    def __init__(self, model):
        if not dist.is_initialized():
            raise RuntimeError("DataParallel needs a process group: run under torchrun "
                               "(python -m torch.distributed.run) or call "
                               "maybe_initialize_distributed first")
        self.model = model
        self.n = world()
        self.rank = rank()
        self.broadcast_state()
        model.reduce_gradients = self.reduce
        norms.set_cross_rank(all_reduce_sum, self.n)

    def broadcast_state(self) -> None:
        """Every parameter and buffer of the nets (running statistics,
        spectral ``u``) and both Adams' state, rank 0's on every rank."""
        tensors = []
        for net in self.model.nets.values():
            tensors += list(net.parameters()) + list(net.buffers())
        for optim in (self.model.optim_g, self.model.optim_d):
            for group in optim.param_groups:
                for p in group["params"]:
                    tensors += [v for v in optim.state.get(p, {}).values()
                                if isinstance(v, torch.Tensor)]
        _broadcast_tensors(tensors)

    def reduce(self, losses: dict, g_grads, d_grads):
        """(losses, g_grads, d_grads) averaged over the ranks: one all-reduce
        per optimizer, the losses riding in G's buffer."""
        names = list(losses)
        g_grads, d_grads = list(g_grads), list(d_grads)
        loss_vec = torch.stack([losses[n].detach().float() for n in names])
        out = []
        for grads, extra in ((g_grads, [loss_vec]), (d_grads, [])):
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [e.to(grads[0].device) for e in extra])
            dist.all_reduce(flat)
            flat.div_(self.n)
            parts, i = [], 0
            for g in grads:
                parts.append(flat[i:i + g.numel()].view(g.shape))
                i += g.numel()
            out.append(parts)
            if extra:
                loss_vec = flat[i:]
        return dict(zip(names, loss_vec.unbind())), out[0], out[1]

    def shard(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (its size a multiple of the
        world's)."""
        n = batch.shape[0]
        if n % self.n:
            raise ValueError(f"a batch of {n} does not split over {self.n} ranks")
        k = n // self.n
        return batch[self.rank * k:(self.rank + 1) * k]

    def batch_sampler(self, dataset):
        """generator -> this rank's (1, cz, cy, cx, 1) crop: every rank draws
        the geometry of all W crops from the one run generator, then cuts
        only crop ``rank`` (JAX's ``split(rng, n)`` then crop i; the draws
        of ``--grad_accum W``)."""
        def sample(generator: torch.Generator) -> torch.Tensor:
            geometry = [dataset.draws(generator) for _ in range(self.n)]
            return dataset.crop(*geometry[self.rank])
        return sample
