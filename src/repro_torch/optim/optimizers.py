"""Optimizers: AdamW, AdamW with int8 block-wise moments, and Adafactor
(twin of ``repro/optim/optimizers.py``).

The interface is the JAX one, with the model config beside the
hyperparameters (``None`` for a tree that is not a target's, such as a
drafter's): ``init(params) -> state`` and
``update(grads, state, params) -> (params, state, metrics)``, over the
port's param trees (nested dicts and the ``layers`` list). Unlike JAX's
immutable arrays, ``update`` writes the new params and moments into the
tensors it is given, and scales the grads in place, under
``torch.no_grad()``: the card holds one copy of each, which is what lets
an 8-layer ``paper-target`` train on one H100. The returned trees are the
objects passed in. The arithmetic is plain torch in fp32 and follows the
JAX expressions term for term.

The moments are laid out as JAX holds them, not as the params are: each
period position's leaf is stacked over the periods (``period/p{j}/...``,
[n_periods, ...]), the tail layers are ``tail{i}/...``. An int8 block of
256, Adafactor's factored second moment (a stacked 1-D leaf is 2-D) and
its update clip all span the layers of one stack, so they need that view.
AdamW proper is elementwise and updates one layer at a time, into views
of the stacked moments. Without a config (a drafter: ``tok``,
``feat_proj``, ``ln_f``, ``head``, ``layer{i}``) every leaf is a group of
its own, as JAX lays out the moments of a tree with no period axis.

On the mesh (``distributed/train_mesh.py``) the params, grads and
moments are the rank's shards, and ``init`` and ``update`` take
``shards`` ({path: the leaf's ``sharding.LeafShard``}, the train plan's
``leaves``). Each computes what JAX's sharded step computes, the whole
leaf's arithmetic, with the sums it needs made over the ranks:

- the global norm is the whole gradient's (each sharded leaf's squares
  summed over the ranks that hold its pieces, a replicated leaf counted
  once);
- AdamW is elementwise and runs on the shards;
- adamw8bit keeps JAX's scales, one a 256-element block of the
  flattened whole (stacked) leaf, replicated as JAX's rules replicate
  ``/s``, but stores a rank's int8 moments in the order of its tile of
  the leaf, not as JAX's tile of the ``[nblk, 256]`` block array: then
  the update needs no exchange of moments, only each block's absolute
  maximum, taken over the ranks that hold pieces of it (one MAX
  all-reduce of both moments' ``[2, nblk]`` a leaf), and a rank never
  holds more of a leaf than its tile (the update's temporaries are a
  chunk of :data:`_Q8_CHUNK` elements'). The bytes a rank stores are
  JAX's, but for the padding of the last block; :func:`gather_state`
  puts JAX's layout back (:func:`shard_state` cuts it again);
- Adafactor's row and column means and the mean of the row statistic
  are sums over the dims another rank holds pieces of, summed over the
  axes that shard them, and so is the update clip's mean square.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig, OptimizerConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import param as pm
from repro_torch.models.blocks import period_spec


# ------------------------------------------------------------- schedules ---
def lr_schedule(hp: OptimizerConfig, step):
    """Warmup then cosine to 10 %: an fp32 0-d tensor for an int ``step``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - hp.warmup_steps)
                       / max(hp.total_steps - hp.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return hp.lr * warm * (0.1 + 0.9 * cos)


def shard_axes(shards) -> dict:
    """{path: the axes of size > 1 of the active mesh a leaf is stored
    over}, of ``shards`` ({path: ``LeafShard``}); {} for None."""
    if not shards:
        return {}
    mesh = sh.active_mesh()
    return {p: tuple(a for a in rec.axes if mesh.size(a) > 1)
            for p, rec in shards.items()}


def global_norm(tree, axes=None):
    """The gradient's L2 norm. ``axes`` ({path: mesh axes}, inside a
    mesh: :func:`shard_axes`): a leaf's squares are summed over the axes
    it is sharded over, one all-reduce for the leaves of each set of
    axes, in tree order."""
    flat = pm.flatten(tree)
    if not axes or not any(axes.values()):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in flat.values()))
    mesh = sh.active_mesh()
    groups = {}
    for path, g in flat.items():
        groups.setdefault(tuple(axes.get(path, ())), []).append(
            torch.sum(torch.square(g.float())))
    total = 0.0
    for ax, sq in groups.items():
        s = torch.stack(sq).sum()
        if ax:
            s = mesh.all_reduce_(s, dist.ReduceOp.SUM, ax)
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, axes=None):
    """Grads scaled to global norm <= ``max_norm`` (fp32 grads in place)."""
    gn = global_norm(grads, axes)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return pm.tree_map(lambda g: g.mul_(scale) if g.dtype == torch.float32
                       else g.float() * scale, grads), gn


# ---------------------------------------------------------- JAX layout ----
def _groups(tree, cfg: Optional[ModelConfig], paths: bool = False):
    """{JAX path: (port leaves, stacked)}: the leaves of a port param tree
    regrouped as the JAX package holds them. A ``period/p{j}`` group lists
    its layers in period order and is ``stacked``; the others hold one.
    ``cfg`` None: each leaf is its own unstacked group. ``paths``: the
    port paths of each group's leaves as a third entry."""
    flat = pm.flatten(tree)
    if cfg is None:
        return {path: ([t], False) + (([path],) if paths else ())
                for path, t in flat.items()}
    spec, n_periods, _ = period_spec(cfg)
    plen = len(spec)
    groups = {}
    for path, t in flat.items():
        parts = path.split("/")
        jpath = path
        if parts[0] == "layers":
            i = int(parts[1])
            head = (f"period/p{i % plen}" if i < plen * n_periods
                    else f"tail{i - plen * n_periods}")
            jpath = "/".join([head] + parts[2:])
        g = groups.setdefault(jpath, ([], jpath.startswith("period/"), []))
        g[0].append(t)
        g[2].append(path)
    return {k: v if paths else v[:2] for k, v in groups.items()}


class _Placed:
    """Where a group's leaves live on this rank: ``rec`` (the first
    leaf's ``LeafShard``: every leaf of a period group is placed alike),
    whether the group is ``stacked`` over ``n`` periods, and the live
    mesh axes of each dim of the group's (stacked) view."""

    def __init__(self, rec, stacked: bool, n: int, mesh):
        self.rec, self.stacked, self.n = rec, stacked, n
        spec = ((None,) if stacked else ()) + tuple(rec.spec)
        self.dim_axes = [tuple(a for a in sh.entry_axes(e)
                               if mesh.size(a) > 1) for e in spec]
        self.axes = tuple(a for ax in self.dim_axes for a in ax)
        self.whole = ((n,) if stacked else ()) + tuple(rec.shape)

    def sum(self, x, dims):
        """``x`` SUM all-reduced over the axes that shard ``dims`` of the
        group's view (negative dims count from its end)."""
        nd = len(self.dim_axes)
        ax = tuple(a for d in dims for a in self.dim_axes[d % nd])
        if ax:
            sh.active_mesh().all_reduce_(x, dist.ReduceOp.SUM, ax)
        return x

    def block_ids(self, device, lo: int, hi: int) -> torch.Tensor:
        """The int8 block (of 256 elements of the flattened whole view)
        of each element of rows ``[lo, hi)`` (the first dim) of the
        rank's tile, in their shape."""
        whole, idx = self.whole, ((slice(0, self.n),) if self.stacked
                                  else ()) + tuple(self.rec.index)
        flat = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(whole))):
            a, b = ((idx[d].start + lo, idx[d].start + hi) if d == 0
                    else (idx[d].start, idx[d].stop))
            shape = [1] * len(whole)
            shape[d] = -1
            flat = flat + (torch.arange(a, b, device=device)
                           * stride).view(shape)
            stride *= whole[d]
        return flat // _Q8_BLOCK

    def chunks(self, shape) -> List[Tuple[int, int]]:
        """Runs of the first dim of a tile of ``shape``, each at most
        :data:`_Q8_CHUNK` elements (at least one row): the int8 update's
        temporaries (the block ids, the dequantized moments) are a
        chunk's, never the whole tile's."""
        row = max(math.prod(shape[1:]), 1)
        step = max(_Q8_CHUNK // row, 1)
        return [(a, min(a + step, shape[0])) for a in range(0, shape[0],
                                                             step)]

    @property
    def nblk(self) -> int:
        return (math.prod(self.whole) + _Q8_BLOCK - 1) // _Q8_BLOCK


def _placed(tree, cfg, shards):
    """{JAX path: :class:`_Placed`} of the groups of ``tree`` that are
    sharded over a live mesh axis (None for the others); {} without
    ``shards``."""
    if not shards:
        return {}
    mesh = sh.active_mesh()
    out = {}
    for path, (ts, stacked, ports) in _groups(tree, cfg, True).items():
        pl_ = _Placed(shards[ports[0]], stacked, len(ts), mesh)
        out[path] = pl_ if pl_.axes else None
    return out


def _nest(flat):
    """{"/"-joined path: leaf} -> nested dicts."""
    out = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def _shape(leaves, stacked):
    return (len(leaves),) + tuple(leaves[0].shape) if stacked \
        else tuple(leaves[0].shape)


def _gather(leaves, stacked):
    """The group as one fp32 tensor: stacked over periods, or the leaf."""
    return torch.stack([t.float() for t in leaves]) if stacked \
        else leaves[0].float()


def _scatter(leaves, stacked, new):
    for t, n in zip(leaves, new if stacked else [new]):
        t.copy_(n)


def _init_state(params, cfg: Optional[ModelConfig], make, shards=None):
    placed = _placed(params, cfg, shards)
    return _nest({path: make(_shape(ts, stacked), ts[0].device,
                             placed.get(path))
                  for path, (ts, stacked) in _groups(params, cfg).items()})


# ------------------------------------------------------- int8 moment util --
_Q8_BLOCK = 256
#: elements of a rank's tile the sharded int8 update works on at once
_Q8_CHUNK = 1 << 24


def _q8(x):
    """Symmetric BLOCK-WISE int8 quantization: a scale per 256 elements
    (the second moment spans many orders of magnitude within a tensor).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % _Q8_BLOCK)).reshape(-1, _Q8_BLOCK)
    amax = fp.abs().amax(dim=1, keepdim=True) + 1e-12
    scale = (amax / 127.0).float()
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dq8(q, scale, shape):
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ------------------------------------------------------------------ AdamW --
def _step0(params):
    """The step counter, on the params' device (a meta trace stays on
    meta)."""
    leaf = next(iter(pm.flatten(params).values()), None)
    meta = leaf is not None and leaf.device.type == "meta"
    return torch.zeros((), dtype=torch.int32,
                       device="meta" if meta else "cpu")


def adamw_init(params, cfg: Optional[ModelConfig],
               quantized: bool = False, shards=None):
    def zero_like(shape, dev, placed):
        if quantized and placed is not None:
            # the rank's tile in its own order; the whole leaf's scales
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.zeros((placed.nblk,), dtype=torch.float32,
                                     device=dev)}
        if quantized:
            nblk = (math.prod(shape) + _Q8_BLOCK - 1) // _Q8_BLOCK
            return {"q": torch.zeros((nblk, _Q8_BLOCK), dtype=torch.int8,
                                     device=dev),
                    "s": torch.zeros((nblk,), dtype=torch.float32,
                                     device=dev)}
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {"m": _init_state(params, cfg, zero_like, shards),
            "v": _init_state(params, cfg, zero_like, shards),
            "step": _step0(params)}


def _adamw8bit_tile(tile: "_Placed", p, g, m, v, upd):
    """adamw8bit on the rank's tile ``p`` (fp32, updated in place) of a
    sharded leaf, in chunks of rows: each chunk's moments dequantized
    with the whole leaf's scales, updated, and each block's absolute
    maximum kept; the maxima are taken over the block's holders (one MAX
    all-reduce of both moments' ``[nblk]``), then each chunk is
    quantized with the new scales (:func:`_q8` of the whole leaf, at
    the tile)."""
    dev = p.device
    m_new, v_new = torch.empty_like(p), torch.empty_like(p)
    amax = torch.zeros((2, tile.nblk), dtype=torch.float32, device=dev)
    chunks = tile.chunks(tuple(p.shape))
    for lo, hi in chunks:
        ids = tile.block_ids(dev, lo, hi)
        m_f = m["q"][lo:hi].float() * m["s"][ids]
        v_f = torch.square(v["q"][lo:hi].float() * v["s"][ids])
        p_c, m_c, v_c = upd(p[lo:hi], g[lo:hi], m_f, v_f)
        p[lo:hi] = p_c
        m_new[lo:hi] = m_c
        # v stored in the sqrt domain
        v_new[lo:hi] = torch.sqrt(v_c)
        for j, x in enumerate((m_new[lo:hi], v_new[lo:hi])):
            amax[j].scatter_reduce_(0, ids.reshape(-1), x.abs().reshape(-1),
                                    "amax")
    if tile.axes:
        sh.active_mesh().all_reduce_(amax, dist.ReduceOp.MAX, tile.axes)
    scale = (amax + 1e-12) / 127.0
    for lo, hi in chunks:
        ids = tile.block_ids(dev, lo, hi)
        for j, (mom, x) in enumerate(((m, m_new), (v, v_new))):
            mom["q"][lo:hi] = torch.clamp(torch.round(
                x[lo:hi] / scale[j][ids]), -127, 127).to(torch.int8)
    m["s"].copy_(scale[0])
    v["s"].copy_(scale[1])


@torch.no_grad()
def adamw_update(grads, state, params, hp: OptimizerConfig,
                 cfg: Optional[ModelConfig], quantized: bool = False,
                 shards=None):
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    grads, gn = clip_by_global_norm(grads, hp.grad_clip, shard_axes(shards))
    b1, b2, eps = hp.b1, hp.b2, hp.eps
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    g_groups = _groups(grads, cfg)
    placed = _placed(params, cfg, shards) if quantized else {}

    def upd(p, g, m_f, v_f):
        m_new = b1 * m_f + (1 - b1) * g
        v_new = b2 * v_f + (1 - b2) * torch.square(g)
        upd_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if quantized:
            # quantization can zero tiny v entries whose m survived
            upd_ = torch.clamp(upd_, -3.0, 3.0)
        return p - lr * (upd_ + hp.weight_decay * p), m_new, v_new

    for path, (ps, stacked) in _groups(params, cfg).items():
        gs = g_groups[path][0]
        m, v = pm.get_path(state["m"], path), pm.get_path(state["v"], path)
        if not quantized:
            # elementwise: a layer at a time, into views of the stacked moments
            for p, g, m_i, v_i in zip(ps, gs, m if stacked else [m],
                                      v if stacked else [v]):
                p_new, m_new, v_new = upd(p.float(), g.float(), m_i, v_i)
                p.copy_(p_new)
                m_i.copy_(m_new)
                v_i.copy_(v_new)
            continue
        tile = placed.get(path)
        if tile is not None:
            # fp32 params: an unstacked group's view is the leaf itself,
            # updated in place chunk by chunk
            p = _gather(ps, stacked)
            _adamw8bit_tile(tile, p, _gather(gs, stacked), m, v, upd)
            _scatter(ps, stacked, p)
            continue
        shape = _shape(ps, stacked)
        m_f = _dq8(m["q"], m["s"], shape)
        # v stored in the sqrt domain (halves the dynamic range an int8
        # linear code must span)
        v_f = torch.square(_dq8(v["q"], v["s"], shape))
        p_new, m_new, v_new = upd(_gather(ps, stacked), _gather(gs, stacked),
                                  m_f, v_f)
        _scatter(ps, stacked, p_new)
        for mom, new in ((m, m_new), (v, torch.sqrt(v_new))):
            q, s = _q8(new)
            mom["q"].copy_(q)
            mom["s"].copy_(s)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gn}


# -------------------------------------------------------------- Adafactor --
def adafactor_init(params, cfg: Optional[ModelConfig], shards=None):
    def factored(shape, dev, placed):
        # a shard's statistics are its rows' and columns' (JAX's rules:
        # vr drops the leaf's last axis, vc its second-to-last)
        z = lambda sh: torch.zeros(sh, dtype=torch.float32,  # noqa: E731
                                   device=dev)
        if len(shape) >= 2:
            return {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
        return {"v": z(shape)}

    return {"v": _init_state(params, cfg, factored, shards),
            "step": _step0(params)}


@torch.no_grad()
def adafactor_update(grads, state, params, hp: OptimizerConfig,
                     cfg: Optional[ModelConfig], shards=None):
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    grads, gn = clip_by_global_norm(grads, hp.grad_clip, shard_axes(shards))
    decay = 1.0 - step.float() ** -0.8
    eps = 1e-30
    g_groups = _groups(grads, cfg)
    placed = _placed(params, cfg, shards)
    for path, (ps, stacked) in _groups(params, cfg).items():
        p = _gather(ps, stacked)
        g = _gather(g_groups[path][0], stacked)
        v = pm.get_path(state["v"], path)
        tile = placed.get(path)
        whole = tile.whole if tile is not None else tuple(p.shape)

        def mean(x, dim):
            # the whole leaf's mean over ``dim``: summed over its holders
            if tile is None:
                return x.mean(dim)
            return tile.sum(x.sum(dim), [dim]) / whole[dim]

        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            vr = decay * v["vr"] + (1 - decay) * mean(g2, -1)
            vc = decay * v["vc"] + (1 - decay) * mean(g2, -2)
            # vr's last dim is the leaf's second-to-last
            vr_mean = (vr.mean(-1) if tile is None else
                       tile.sum(vr.sum(-1), [-2]) / whole[-2])
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr_mean[..., None, None], min=eps))
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vv = decay * v["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(torch.clamp(vv, min=eps))
            v["v"].copy_(vv)
        # update clipping (Adafactor d=1.0)
        sq = torch.square(u)
        msq = (torch.mean(sq) if tile is None else
               tile.sum(sq.sum(), range(p.ndim)) / math.prod(whole))
        rms_u = torch.sqrt(msq + eps)
        u = u / torch.clamp(rms_u, min=1.0)
        _scatter(ps, stacked, p - lr * (u + hp.weight_decay * p))
    return params, {"v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gn}


def _state_dims(state, params, cfg, shards):
    """{state path: (the group's placement or None, the live axes of each
    dim of the leaf, its statistic: "", "q", "s", "vr", "vc", "v")}."""
    placed = _placed(params, cfg, shards)
    out = {}
    for key in pm.flatten(state):
        kind, _, rest = key.partition("/")
        group, stat = rest, ""
        if rest not in placed:
            group, _, stat = rest.rpartition("/")
        tile = placed.get(group) if kind in ("m", "v") else None
        dims = None if tile is None else tile.dim_axes
        if dims is not None and stat == "vr":
            dims = dims[:-1]
        elif dims is not None and stat == "vc":
            dims = dims[:-2] + dims[-1:]
        out[key] = (tile, dims, stat)
    return out


def shard_state(whole, params, cfg: Optional[ModelConfig], shards):
    """A rank's optimizer state cut from the whole state in JAX's layout
    (the inverse of :func:`gather_state`): each moment's slice of the
    rank's tile, an int8 moment's blocks unpadded into the tile's
    order."""
    out = {}
    where = _state_dims(whole, params, cfg, shards)
    for key, t in pm.flatten(whole).items():
        tile, _, stat = where[key]
        if tile is None or stat == "s":
            out[key] = t
            continue
        idx = ((slice(0, tile.n),) if tile.stacked else ()) + tuple(
            tile.rec.index)
        if stat == "vr":
            idx = idx[:-1]
        elif stat == "vc":
            idx = idx[:-2] + idx[-1:]
        if stat == "q":
            t = t.reshape(-1)[:math.prod(tile.whole)].reshape(tile.whole)
        out[key] = t[idx].clone()
    return pm.unflatten_like(whole, out)


def gather_state(state, params, cfg: Optional[ModelConfig], shards):
    """The whole optimizer state in JAX's layout, from a rank's (every
    rank gets it; collective over the mesh): each moment all-gathered
    over the axes of its group's dims, an int8 moment in tile order
    then cut into JAX's ``[nblk, 256]`` blocks. ``params``: the rank's
    params (the groups' layout); ``shards``: as ``update`` takes them."""
    mesh = sh.active_mesh()
    where = _state_dims(state, params, cfg, shards)
    out = {}
    for key, t in pm.flatten(state).items():
        tile, dims, stat = where[key]
        if tile is None or stat == "s":
            out[key] = t
            continue
        for d, ax in enumerate(dims):
            if ax:
                t = mesh.all_gather(t, ax).movedim(0, d).flatten(d, d + 1)
        if stat == "q":
            flat = t.reshape(-1)
            t = F.pad(flat, (0, (-flat.numel()) % _Q8_BLOCK)).reshape(
                -1, _Q8_BLOCK)
        out[key] = t
    return pm.unflatten_like(state, out)


# ------------------------------------------------------------- dispatcher --
def make_optimizer(hp: OptimizerConfig, cfg: Optional[ModelConfig] = None):
    """(init, update) for ``hp.name``; ``cfg`` gives the period layout of
    a target's moments (None: one group a leaf, for any other tree).
    ``init(p, shards=None)`` and ``update(g, s, p, shards=None)``:
    ``shards`` on the mesh (the train plan's ``leaves``)."""
    if hp.name in ("adamw", "adamw8bit"):
        q = hp.name == "adamw8bit"
        return (lambda p, shards=None: adamw_init(p, cfg, q, shards),
                lambda g, s, p, shards=None: adamw_update(
                    g, s, p, hp, cfg, q, shards))
    if hp.name == "adafactor":
        return (lambda p, shards=None: adafactor_init(p, cfg, shards),
                lambda g, s, p, shards=None: adafactor_update(
                    g, s, p, hp, cfg, shards))
    raise ValueError(hp.name)
