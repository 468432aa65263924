"""Device mesh, sharding rules and the collectives of data and tensor
parallelism (counterpart of `adaface_tpu/parallel/mesh.py`).

JAX runs one SPMD program over the global batch and lets GSPMD insert the
collectives. The port runs one process per rank (`torch.distributed`), so
every rank computes its slice of the same global step and the collectives
are explicit. The mesh is passed explicitly: the step builders, the losses
and the optimizers take `mesh=None` (one device) and the layer that owns a
batch decides whether its reductions are global.

- **One host stream, sliced.** Every rank runs the same seeded host RNGs and
  draws the global batch; `shard_train_batch` then keeps the rank's rows
  (the slicing rule of JAX's `train_batch_shardings`: dim 0, dim 1 for the
  per-step noise fields, the per-iteration knobs replicated, a degenerate
  leading 1 replicated, DreamBooth's halves recursed into). The fields a
  batch type names in `TYPE_MAJOR` are its 4-type prompt battery (`[4B,
  ...]`, type-major): the rank keeps its blocks of each type.
- **Gradients.** `Mesh.all_reduce_mean_` averages the trainables' gradients
  over `dp` in one flat bucket (`training/train_step._with_optimizer`).
- **Global reductions.** `global_sum(x, mesh)` makes a batch reduction
  global: its value is the sum over every rank, its gradient flows into
  this rank's part scaled by `dp`, so the dp-mean of the gradients is the
  gradient of the global function (a ratio of sums, a hinge on a mean, a
  norm).
- **ZeRO-1.** `zero1_sharding_rules` names the dim each optimizer-state leaf
  shards on (`training/prodigy.Zero1Layout` holds the slices).
- **Tensor parallelism.** `param_sharding_rules` splits the UNet's q/k/v and
  feed-forward-in weights by output (column) and its out-projections by
  input (row), Megatron's pairs (`models/unet.shard_unet_tp`).

The only collective is `all_reduce` (gloo on CUDA tensors has all-reduce,
broadcast and barrier only, and gloo is what lets two ranks share one card:
NCCL refuses two ranks on one device). A gather is an all-reduce of a
zero-filled buffer. The backend is NCCL on CUDA and gloo on the CPU unless the caller
names one.

`launch(fn, n, ...)` starts `n` ranks (`torch.multiprocessing`'s spawn
context, a `FileStore` rendezvous in a temporary directory, so concurrent
runs never collide on a port); a process started by `torchrun` joins its
group instead (`make_mesh` reads `RANK` / `WORLD_SIZE` / `LOCAL_RANK`).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_lib
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a ZeRO-1 leaf must hold at least this many elements (JAX's min_elems)
MIN_ZERO1_ELEMS = 65536
# the prompt types of a compositional battery (subject single / comp, class
# single / comp), the groups of a batch's `TYPE_MAJOR` fields
PROMPT_TYPES = 4

# per-iteration host-sampled knobs that replicate even when their leading
# dim happens to divide dp (the JAX package's set)
_REPLICATED_BATCH_FIELDS = frozenset({
    "skip_weights", "emb_noise_key", "emb_noise_std", "dropout_key",
    "training_percent", "compel_level", "cls_mix_ranges",
    "preserve_loss_scale",
})
# leading dim is the denoising-step axis S, the batch rides dim 1
# (Arc2FaceBatch.noises [S, B, h, w, 4] / relative_ts [S-1, B])
_DIM1_BATCH_FIELDS = frozenset({"noises", "relative_ts"})

# the device `launch` gave this rank (cuda:<i> or cpu)
_RANK_DEVICE: Optional[torch.device] = None


class Mesh:
    """A dp x tp mesh over the ranks of one process group: rank = dp_rank *
    tp + tp_rank. `dp_group` / `tp_group` are None where that axis has one
    rank (its collectives are no-ops)."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 dp_group=None, tp_group=None, backend: Optional[str] = None):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.device = device
        self.dp_group, self.tp_group = dp_group, tp_group
        self.backend = backend

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files."""
        return self.rank == 0

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")

    # ------------------------------------------------------------ collectives
    def all_reduce_(self, t: torch.Tensor, axis: str = "dp") -> torch.Tensor:
        """Sum `t` in place over the `axis` ranks ("dp", "tp" or "world")."""
        group = {"dp": self.dp_group, "tp": self.tp_group}.get(axis, dist.group.WORLD)
        n = {"dp": self.dp, "tp": self.tp}.get(axis, self.size)
        if n > 1:
            dist.all_reduce(t, group=group)
        return t

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average the tensors in place over dp, in one flat fp32 bucket."""
        if self.dp == 1 or not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        self.all_reduce_(flat)
        flat /= self.dp
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape).to(t.dtype))
            off += n

    # --------------------------------------------------------------- batches
    def local_rows(self, n_global: int, groups: int = 1) -> Optional[np.ndarray]:
        """Global indices of this rank's rows of an `n_global`-row dim made of
        `groups` type-major groups (each group's rows split into dp equal
        blocks), or None where the dim replicates (dp 1, a dim that dp does
        not divide, or the degenerate 1)."""
        if (self.dp == 1 or n_global <= 1 or n_global % groups
                or (n_global // groups) % self.dp):
            return None
        per_group = n_global // groups
        b = per_group // self.dp
        start = self.dp_rank * b
        return np.concatenate([np.arange(k * per_group + start, k * per_group + start + b)
                               for k in range(groups)])

    def gather_rows(self, local: Optional[torch.Tensor], n_global: int) -> Optional[torch.Tensor]:
        """The global [n_global, ...] tensor from each rank's rows
        (`local_rows`): an all-reduce over dp of a zero-filled buffer. Ranks
        of one tp group hold the same rows; a dim that replicates comes back
        as it is."""
        if local is None:
            return None
        idx = self.local_rows(n_global)
        if idx is None:
            return local
        full = torch.zeros((n_global,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[torch.as_tensor(idx, device=local.device)] = local
        return self.all_reduce_(full)


def dp_of(mesh: Optional[Mesh]) -> int:
    """The dp size of `mesh` (1 without one)."""
    return 1 if mesh is None else mesh.dp


def is_main(mesh: Optional[Mesh]) -> bool:
    """True on rank 0 of `mesh`, or without one."""
    return mesh is None or mesh.is_main


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A batch reduction made global: the value is the sum of `x` over the
    dp ranks, the gradient flows into this rank's `x` times dp, so that the
    dp-mean of the gradients equals the gradient of any function of the
    global sum. Each rank passes its own part (a rank without a part passes
    zeros). `x` itself without a dp mesh."""
    if dp_of(mesh) == 1:
        return x
    total = mesh.all_reduce_(x.detach().clone())
    if not x.requires_grad:
        return total
    scaled = x * mesh.dp
    return scaled - scaled.detach() + total


def global_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean over every rank's elements of a batch-sliced `x` (equal
    parts); `x.mean()` without a dp mesh."""
    if dp_of(mesh) == 1:
        return x.mean()
    return global_sum(x.sum(), mesh) / (x.numel() * mesh.dp)


def on_block0(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A loss of the global batch's block 0 alone, which this rank holds
    only when its dp rank is 0: `x` there, zero elsewhere, made global."""
    if dp_of(mesh) == 1:
        return x
    return global_sum(x if mesh.dp_rank == 0 else x * 0.0, mesh)


def global_rows(mesh: Optional[Mesh], n_local: int,
                groups: int = 1) -> Tuple[Optional[np.ndarray], int]:
    """(this rank's global row indices or None, the global row count) of a
    batch-sliced dim with `n_local` local rows (the inverse of
    `shard_train_batch`'s slicing): (None, n_local) without a dp mesh."""
    if dp_of(mesh) == 1:
        return None, n_local
    return mesh.local_rows(n_local * mesh.dp, groups), n_local * mesh.dp


def draw_rows(shape, dim: int, generator: Optional[torch.Generator], device,
              dtype=torch.float32, mesh: Optional[Mesh] = None,
              groups: int = 1) -> torch.Tensor:
    """A standard normal draw of a batch-sliced tensor of local `shape` whose
    batch rides `dim`: drawn at the global shape and this rank's rows taken,
    so that dp ranks draw what one device draws for the whole batch."""
    idx, n = global_rows(mesh, shape[dim], groups)
    full = list(shape)
    full[dim] = n
    out = torch.randn(tuple(full), generator=generator, device=device, dtype=dtype)
    return out if idx is None else out.index_select(dim, torch.as_tensor(idx, device=out.device))


def metrics_mean(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """The metrics averaged over dp (the global ones), one bucket."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.numel() == 1]
    if dp_of(mesh) == 1 or not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().float().reshape(()).to(mesh.device) for k in keys])
    mesh.all_reduce_(vals)
    vals /= mesh.dp
    out = dict(metrics)
    out.update({k: vals[i] for i, k in enumerate(keys)})
    return out


# ------------------------------------------------------------------- launch
def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The dp x tp mesh of this process's group. In a rank of `launch` or of
    `torchrun` (which this joins from its environment: NCCL on
    cuda:<LOCAL_RANK>, gloo without a card); a process outside any group
    gets a one-device mesh. Raises as JAX does when dp x tp != the device
    count, and when the group holds another number of ranks."""
    global _RANK_DEVICE
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device(f"cuda:{local}" if torch.cuda.is_available() else "cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        _RANK_DEVICE = dev
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = n_devices or world
    dp = dp or (n // tp)
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} ranks: start {n} "
                         "ranks (parallel.mesh.launch, or torchrun)")
    dev = _RANK_DEVICE or torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dp_group = tp_group = None
    if world > 1:
        whole = dist.group.WORLD
        # every rank builds every group, in the same order
        dp_groups = ([whole] if tp == 1 else
                     [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)])
        tp_groups = ([whole] if dp == 1 else
                     [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)])
        dp_group = dp_groups[rank % tp] if dp > 1 else None
        tp_group = tp_groups[rank // tp] if tp > 1 else None
    return Mesh(dp, tp, rank, dev, dp_group, tp_group,
                dist.get_backend() if dist.is_initialized() else None)


def in_group() -> bool:
    """True in a rank of a process group (launched, or by torchrun)."""
    return dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1


def rank_device() -> Optional[torch.device]:
    """The device `launch` gave this rank, or None outside a launched rank."""
    return _RANK_DEVICE


def _rank_main(rank: int, world: int, store_path: str, backend: str, devices: List[str],
               threads: Optional[int], timeout_s: Optional[float], fn: Callable, args: tuple,
               results):
    """One rank of `launch`: its device and threads, the group, `fn(*args)`,
    the result to the queue (an exception reaches the parent through
    `torch.multiprocessing`'s error channel)."""
    global _RANK_DEVICE
    dev = torch.device(devices[rank])
    if threads or dev.type == "cpu":
        # CPU ranks share the cores
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // world))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, **kw)
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: tuple = (), *, device: str = "cuda",
           devices: Optional[Sequence[str]] = None, backend: Optional[str] = None,
           threads: Optional[int] = None, timeout: Optional[float] = None) -> List[object]:
    """Run `fn(*args)` on `nprocs` new ranks of one process group and return
    each rank's result, in rank order. Rank r runs on `devices[r]`, by
    default `cuda:<r>` (or the CPU for `device="cpu"`, each rank then taking
    its share of the cores unless `threads` says); the backend is NCCL on
    CUDA and gloo on the CPU unless named (gloo lets ranks share a card).
    `fn` and `args` must pickle (spawn context); `fn` builds its mesh with
    `make_mesh`. Ranks rendezvous through a `FileStore` in a temporary
    directory. A rank that raises fails the launch with its traceback (the
    others are ended); with a `timeout`, ranks that have not ended after
    that many seconds are killed and the launch raises TimeoutError (a
    collective that waits longer raises in its rank)."""
    if devices is None:
        devices = [("cpu" if torch.device(device).type == "cpu" else f"cuda:{r}")
                   for r in range(nprocs)]
    devices = [str(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    backend = backend or ("nccl" if torch.device(devices[0]).type == "cuda" else "gloo")
    mp = torch.multiprocessing
    tmp = tempfile.mkdtemp(prefix="adaface_mesh_")
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(_rank_main, args=(nprocs, os.path.join(tmp, "store"), backend,
                                               devices, threads, timeout, fn, args, results),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.time() + timeout
    got = {}
    try:
        # the results are taken as they come (a rank cannot end before its
        # result has left the queue)
        while len(got) < nprocs or not ctx.join(timeout=1.0):
            try:
                rank, value = results.get(timeout=0.1)
                got[rank] = value
            except queue_lib.Empty:
                ctx.join(timeout=0.0)  # raises with a failed rank's traceback
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not end within {timeout:.0f} s")
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"rank {e.error_index} failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"rank {e.error_index} died with exit code {e.exit_code}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(nprocs)]


# ------------------------------------------------------------- batch rules
def _leaf_dim(x, dim1: bool, dp: int) -> Optional[int]:
    shape = getattr(x, "shape", None)
    if shape is None or len(shape) == 0:
        return None
    if dim1:
        ok = len(shape) >= 2 and shape[1] % dp == 0 and shape[1] > 1
        return 1 if ok else None
    return 0 if shape[0] % dp == 0 and shape[0] > 1 else None


def _tree_map(fn, tree):
    """`fn` over the array leaves of dicts, tuples and lists (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_asdict"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def train_batch_shardings(mesh: Mesh, batch):
    """The dim each leaf of a train-step batch NamedTuple shards on over dp
    (0, 1, or None = replicated), JAX's `train_batch_shardings` rule: dim 0
    (dim 1 for `noises` / `relative_ts`) when dp divides it and it is not
    the degenerate 1; the per-iteration knobs replicate; a nested batch
    (DreamBoothBatch.train / .reg) recurses."""
    out = {}
    for name, val in batch._asdict().items():
        if name in _REPLICATED_BATCH_FIELDS:
            out[name] = _tree_map(lambda _: None, val)
        elif hasattr(val, "_asdict"):
            out[name] = train_batch_shardings(mesh, val)
        else:
            dim1 = name in _DIM1_BATCH_FIELDS
            out[name] = _tree_map(lambda x: _leaf_dim(x, dim1, mesh.dp), val)
    return type(batch)(**out)


def _take(x, dim: int, idx: np.ndarray):
    if torch.is_tensor(x):
        return x.index_select(dim, torch.as_tensor(idx, device=x.device))
    return np.take(np.asarray(x), idx, axis=dim)


def shard_train_batch(mesh: Optional[Mesh], batch):
    """This rank's part of a global train batch (`train_batch_shardings`'
    rule). The fields the batch type names in `TYPE_MAJOR` are its 4-type
    prompt battery, PROMPT_TYPES type-major groups each split alike: the
    rank keeps its blocks of every prompt type. The batch as it is without
    a dp mesh."""
    if dp_of(mesh) == 1:
        return batch
    dims = train_batch_shardings(mesh, batch)
    type_major = getattr(batch, "TYPE_MAJOR", frozenset())
    out = {}
    for name, val in batch._asdict().items():
        d = getattr(dims, name)
        if hasattr(val, "_asdict"):
            out[name] = shard_train_batch(mesh, val)
            continue
        groups = PROMPT_TYPES if name in type_major else 1

        def leaf(x, dd):
            if dd is None:
                return x
            idx = mesh.local_rows(int(x.shape[dd]), groups if dd == 0 else 1)
            return x if idx is None else _take(x, dd, idx)

        if isinstance(val, dict):
            out[name] = {k: leaf(v, d[k]) for k, v in val.items()}
        elif isinstance(val, (tuple, list)):
            out[name] = type(val)(leaf(v, dd) for v, dd in zip(val, d))
        else:
            out[name] = leaf(val, d)
    return type(batch)(**out)


# ------------------------------------------------------------ tensor parallel
def _match(path: str, *subs: str) -> bool:
    return any(s in path for s in subs)


def param_sharding_rules(mesh: Mesh, params: dict) -> dict:
    """name -> the dim of a torch weight ([out, in]) that shards over tp: 0
    (column: q/k/v and feed-forward-in, split by output features), 1 (row:
    the out-projections, split by input features) or None (replicated: every
    other leaf, and every leaf that is not 2-D). JAX's name substrings, for
    the UNet ('to_q/to_k/to_v/to_out', 'ff_in/ff_out') and the CLIP towers
    ('q_proj/k_proj/v_proj/out_proj', 'fc1/fc2')."""
    out = {}
    for name, leaf in params.items():
        path = name.replace(".", "/")
        if (leaf.dim() if torch.is_tensor(leaf) else np.ndim(leaf)) != 2:
            out[name] = None
        elif _match(path, "to_q/", "to_k/", "to_v/", "ff_in/",
                    "q_proj/", "k_proj/", "v_proj/", "fc1/"):
            out[name] = 0
        elif _match(path, "to_out/", "ff_out/", "out_proj/", "fc2/"):
            out[name] = 1
        else:
            out[name] = None
    return out


# ------------------------------------------------------- optimizer sharding
def _zero1_dim(shape, n: int, min_elems: int = MIN_ZERO1_ELEMS) -> Optional[int]:
    """The dim a state leaf of `shape` shards on over n ranks: its largest
    axis that n divides (the last of equal ones, as JAX's max picks), None
    below `min_elems` elements or with no divisible axis."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or int(np.prod(shape)) < min_elems:
        return None
    cands = [(s, i) for i, s in enumerate(shape) if s % n == 0]
    if not cands:
        return None
    return max(cands)[1]


def zero1_sharding_rules(mesh: Mesh, opt_state):
    """The ZeRO-1 dim over dp of each leaf of an optimizer-state tree (dicts,
    tuples, lists of tensors or arrays; None = replicated): JAX's
    `zero1_sharding_rules`. Without a second dp rank every leaf
    replicates."""

    def rule(leaf):
        shape = getattr(leaf, "shape", None)
        return None if shape is None or mesh.dp == 1 else _zero1_dim(shape, mesh.dp)

    return _tree_map(rule, opt_state)
