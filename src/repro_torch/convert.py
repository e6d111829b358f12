"""Carry state and weights between this package and the JAX reference.

* Online-store state: the six primary arrays of an online store — ring
  ts / vals / cursor and bucket stats / bitmap / ids — the merge-order
  bucket families where the layout persists them, and the secondary
  rings (ts / vals / cursor of each ring of ``layout.tables``) as numpy,
  either single-device ``(K, ...)`` or sharded ``(S, K_local, ...)``.  The
  tests seed both packages' stores from the same warm state with these,
  and read states back to compare them bit for bit.
* Model weights: :func:`decoder_from_numpy` builds a
  :class:`~repro_torch.models.transformer.DecoderLM` (dense or MoE),
  :func:`rwkv6_from_numpy` a :class:`~repro_torch.models.rwkv6.RWKV6LM`,
  :func:`griffin_from_numpy` a :class:`~repro_torch.models.griffin.
  GriffinLM` and :func:`encdec_from_numpy` an :class:`~repro_torch.models.
  encdec.EncDecLM`, from the reference model's parameter tree as numpy
  arrays.
  Their inverses :func:`decoder_to_numpy`, :func:`rwkv6_to_numpy`,
  :func:`griffin_to_numpy` and :func:`encdec_to_numpy` return the
  reference's tree (per-layer parameters stacked on a leading axis);
  :func:`reference_tree` builds that tree from any per-parameter mapping
  (gradients, optimizer moments) and :func:`reference_names` lists the
  parameters in the reference's leaf order (JAX's flatten: dict keys
  sorted at every level, a stacked leaf's layers in order).
* Optimizer state: :func:`adamw_state_to_numpy` /
  :func:`adamw_state_from_numpy` carry AdamW's ``master`` / ``m`` / ``v``
  (and ``ef_residual``) trees and ``step`` in the reference's layout.
* Serving state: :func:`kv_cache_from_numpy` (the decoder's caches),
  :func:`griffin_state_from_numpy` and :func:`encdec_state_from_numpy`
  turn the reference's state into the port's, bf16 bits kept.

numpy has no bfloat16 without a JAX dependency, so the ``*_to_numpy``
functions return a bfloat16 parameter as float32 (exact: every bf16 value
is a float32 value), which ``*_from_numpy`` takes back bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.online import OnlineState

__all__ = [
    "STATE_ARRAYS",
    "FAMILY_ARRAYS",
    "SEC_ARRAYS",
    "online_state_from_numpy",
    "online_state_to_numpy",
    "decoder_from_numpy",
    "rwkv6_from_numpy",
    "griffin_from_numpy",
    "encdec_from_numpy",
    "decoder_to_numpy",
    "rwkv6_to_numpy",
    "griffin_to_numpy",
    "encdec_to_numpy",
    "reference_names",
    "reference_tree",
    "tree_to_numpy",
    "load_reference_tree",
    "adamw_state_to_numpy",
    "adamw_state_from_numpy",
    "kv_cache_from_numpy",
    "griffin_state_from_numpy",
    "encdec_state_from_numpy",
]

# names and dtypes of the six primary arrays, in kernel argument order
STATE_ARRAYS = (
    ("ring_ts", np.int32),
    ("ring_vals", np.float32),
    ("cursor", np.int32),
    ("bstats", np.float32),
    ("bbitmap", np.int32),
    ("bbucket", np.int32),
)


# the merge-order bucket families (``BucketAgg`` fields), named
# ``b<field>``: ``bseq`` with either family, ``bx*`` with the extreme one
# (FIRST / LAST), ``bt*`` with the tail (TOPN_FREQ)
FAMILY_ARRAYS = (
    ("bseq", np.int32),
    ("bxts", np.int32), ("bxpos", np.int32), ("bxval", np.float32),
    ("bxhas", np.bool_),
    ("btts", np.int32), ("btpos", np.int32), ("btval", np.float32),
    ("btvalid", np.bool_),
)


def _family_arrays(extreme: bool, tail: bool):
    """The :data:`FAMILY_ARRAYS` a bucket plan with these families has."""
    return [(n, d) for n, d in FAMILY_ARRAYS
            if (n == "bseq" and (extreme or tail))
            or (n.startswith("bx") and extreme)
            or (n.startswith("bt") and tail)]


# fields and dtypes of each secondary ring, named ``sec{i}_<field>``
SEC_ARRAYS = (("ts", np.int32), ("vals", np.float32), ("cursor", np.int32))


def _sec_names(n_rings: int):
    return [f"sec{i}_{f}" for i in range(n_rings) for f, _ in SEC_ARRAYS]


def online_state_from_numpy(
    arrays: Union[Mapping[str, np.ndarray], Sequence[np.ndarray]],
    device="cuda",
    *,
    bucket_size: int,
    layout=None,
) -> OnlineState:
    """An :class:`OnlineState` on ``device`` holding copies of ``arrays``:
    a mapping keyed by :data:`STATE_ARRAYS` names, or the six arrays in
    that order; ``bucket_size`` is the bucket width the states were
    aggregated with.

    With ``layout`` (the store's :class:`~repro_torch.core.layout.
    StoreLayout`), ``arrays`` also holds the merge-order families its
    bucket plan persists (:data:`FAMILY_ARRAYS`; a sequence gives them
    after the six) and every secondary ring of ``layout.tables`` —
    ``sec{i}_ts``, ``sec{i}_vals``, ``sec{i}_cursor`` (:data:`SEC_ARRAYS`;
    a sequence gives them last, ring by ring).  On a sharded layout a
    replicated ring arrives as the reference's S replicas ``(S, K_t,
    ...)``: they must be equal (else ``ValueError``), and one copy is
    kept, seen as S replicas through a view with stride 0, as the port's
    sharded store holds it."""
    n_sec = len(layout.tables) if layout is not None else 0
    fams = (_family_arrays(layout.bucket.extreme, layout.bucket.tail)
            if layout is not None else [])
    names = ([name for name, _ in STATE_ARRAYS] + [n for n, _ in fams]
             + _sec_names(n_sec))
    dtypes = ([d for _, d in STATE_ARRAYS] + [d for _, d in fams]
              + [d for _, d in SEC_ARRAYS] * n_sec)
    if isinstance(arrays, Mapping):
        extra = sorted(set(arrays) - set(names))
        if extra:
            raise ValueError(f"unexpected arrays {extra} (merge-order "
                             "families and secondary rings need the "
                             "store's layout=)")
        arrays = [arrays[name] for name in names]
    if len(arrays) != len(names):
        raise ValueError(f"need {len(names)} arrays, got {len(arrays)}")
    dev = resolve_device(device)
    host = []
    for name, dtype, a in zip(names, dtypes, arrays):
        a = np.asarray(a)
        if a.dtype != dtype:
            raise TypeError(f"{name}: expected {np.dtype(dtype)}, got {a.dtype}")
        host.append(a)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket = (
        put(a) for a in host[:6])
    family = {n[1:]: put(a) for (n, _), a in zip(fams, host[6:])}
    sec = []
    sharded = layout is not None and layout.num_shards is not None
    first = 6 + len(fams)
    for i, p in enumerate(layout.tables if layout is not None else ()):
        parts = host[first + 3 * i: first + 3 * i + 3]
        if sharded and not p.partitioned:
            S = int(layout.num_shards)
            for (f, _), a in zip(SEC_ARRAYS, parts):
                if a.shape[0] != S:
                    raise ValueError(
                        f"sec{i}_{f} ({p.table}, replicated): expected {S} "
                        f"replicas, got shape {a.shape}")
                bits = a.view(np.int32)
                for s in range(1, S):
                    if not np.array_equal(bits[s], bits[0]):
                        raise ValueError(
                            f"sec{i}_{f} ({p.table}, replicated): replica "
                            f"{s} differs from replica 0")
            ring = st.RingStore(*(
                put(a[0]).unsqueeze(0).expand(a.shape) for a in parts))
        else:
            ring = st.RingStore(*(put(a) for a in parts))
        sec.append(ring)
    return OnlineState(
        ring=st.RingStore(ts=ring_ts, vals=ring_vals, cursor=cursor),
        bagg=pg.BucketAgg(
            stats=bstats, bitmap=bbitmap, bucket=bbucket, size=bucket_size,
            **family,
        ),
        sec=tuple(sec),
    )


def online_state_to_numpy(state: OnlineState) -> Dict[str, np.ndarray]:
    """The six primary arrays, the merge-order families present
    (``bseq``, ``bxts``, ... of :data:`FAMILY_ARRAYS`) and the secondary
    rings of ``state`` (``sec{i}_ts`` / ``sec{i}_vals`` / ``sec{i}_cursor``,
    in ``state.sec`` order) as host numpy copies; a replicated ring of a
    sharded store comes back as its S replicas, the reference's shape."""
    fam = state.bagg.families()
    tensors = list(state.arrays()) + list(fam.values())
    for ring in state.sec:
        tensors += [ring.ts, ring.vals, ring.cursor]
    names = ([name for name, _ in STATE_ARRAYS] + [f"b{f}" for f in fam]
             + _sec_names(len(state.sec)))
    return {
        name: np.array(t.detach().cpu().numpy(), copy=True)
        for name, t in zip(names, tensors)
    }


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def _load_numpy(model, params: Mapping, stacked: Mapping[str, Tuple[str, int]],
                who: str):
    """Copy the reference's parameter tree (numpy leaves) into ``model``.
    ``stacked`` maps a top-level name of the tree to ``(module, n)``:
    leaves under ``<name>.*`` are stacked on a leading axis of ``n`` and go
    to ``<module>.<i>.*``; the others go by their own name.  Every
    parameter must be given, each with its parameter's shape; values pass
    through float32, so a bfloat16 tree arrives bit for bit in bfloat16
    parameters."""
    own = dict(model.named_parameters())
    unset = set(own)

    def put(name: str, a) -> None:
        if name not in own:
            raise KeyError(f"{who}: no parameter {name!r}")
        p = own[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"{who}: {name} has shape {tuple(a.shape)}, the model's is "
                f"{tuple(p.shape)}"
            )
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        with torch.no_grad():
            p.copy_(t.to(device=p.device, dtype=p.dtype))
        unset.discard(name)

    for name, a in _flatten(params):
        a = np.asarray(a)
        top, _, rest = name.partition(".")
        if top in stacked:
            module, n = stacked[top]
            if a.shape[0] != n:
                raise ValueError(
                    f"{who}: {name} stacks {a.shape[0]} layers, the config "
                    f"has {n}"
                )
            for i in range(n):
                put(f"{module}.{i}.{rest}", a[i])
        else:
            put(name, a)
    if unset:
        raise KeyError(f"{who}: parameters not given: {sorted(unset)}")
    return model


def decoder_from_numpy(cfg, params: Mapping, device="cuda"):
    """A :class:`~repro_torch.models.transformer.DecoderLM` of ``cfg`` on
    ``device`` holding the reference model's weights.

    ``params`` is the reference's parameter tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): ``embed.table`` (and
    ``embed.head`` when untied), the per-layer parameters stacked on a
    leading layer axis under ``layers.*`` (``layers.mlp.*`` or, in the
    ``moe`` family, ``layers.moe.{router,w_in,w_gate,w_out}``), and
    ``ln_out.scale``.
    """
    from repro_torch.models.transformer import DecoderLM

    return _load_numpy(DecoderLM(cfg, device=device), params,
                       {"layers": ("blocks", cfg.n_layers)},
                       "decoder_from_numpy")


def rwkv6_from_numpy(cfg, params: Mapping, device="cuda"):
    """A :class:`~repro_torch.models.rwkv6.RWKV6LM` of ``cfg`` on
    ``device`` holding the reference model's weights: ``embed.table``,
    ``layers.{ln_tm,tm,ln_cm,cm}.*`` stacked on a leading layer axis, and
    ``ln_out.scale``, with numpy leaves."""
    from repro_torch.models.rwkv6 import RWKV6LM

    return _load_numpy(RWKV6LM(cfg, device=device), params,
                       {"layers": ("layers", cfg.n_layers)}, "rwkv6_from_numpy")


def griffin_from_numpy(cfg, params: Mapping, device="cuda"):
    """A :class:`~repro_torch.models.griffin.GriffinLM` of ``cfg`` on
    ``device`` holding the reference model's weights: ``embed.table``,
    each super-block's parameters stacked on a leading axis under
    ``supers.*``, the tail blocks under ``tails.t<i>.*`` (not stacked), and
    ``ln_out.scale``, with numpy leaves."""
    from repro_torch.models.griffin import GriffinLM

    model = GriffinLM(cfg, device=device)
    return _load_numpy(model, params, {"supers": ("supers", model.n_super)},
                       "griffin_from_numpy")


def encdec_from_numpy(cfg, params: Mapping, device="cuda"):
    """An :class:`~repro_torch.models.encdec.EncDecLM` of ``cfg`` on
    ``device`` holding the reference model's weights: ``embed.table``, the
    encoder's and the decoder's layers stacked under ``enc_layers.*`` and
    ``dec_layers.*``, ``ln_enc`` and ``ln_out``, with numpy leaves."""
    from repro_torch.models.encdec import EncDecLM

    return _load_numpy(EncDecLM(cfg, device=device), params,
                       {"enc_layers": ("enc_layers", cfg.n_encoder_layers),
                        "dec_layers": ("dec_layers", cfg.n_layers)},
                       "encdec_from_numpy")


def _stacked(model) -> Dict[str, Tuple[str, int]]:
    """The reference tree's stacked top-level names of ``model``'s family:
    name -> (the port's module list, the number of layers)."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.griffin import GriffinLM
    from repro_torch.models.rwkv6 import RWKV6LM
    from repro_torch.models.transformer import DecoderLM

    cfg = model.cfg
    if isinstance(model, DecoderLM):
        return {"layers": ("blocks", cfg.n_layers)}
    if isinstance(model, RWKV6LM):
        return {"layers": ("layers", cfg.n_layers)}
    if isinstance(model, GriffinLM):
        return {"supers": ("supers", model.n_super)}
    if isinstance(model, EncDecLM):
        return {"enc_layers": ("enc_layers", cfg.n_encoder_layers),
                "dec_layers": ("dec_layers", cfg.n_layers)}
    raise TypeError(f"no reference tree layout for {type(model).__name__}")


def _leaf_paths(model) -> Dict[Tuple[str, ...], List[str]]:
    """Reference leaf path -> the port's parameter names that make it (one,
    or one per layer in layer order), in the reference's leaf order."""
    by_module = {module: top for top, (module, _) in _stacked(model).items()}
    groups: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in by_module:
            path, layer = (by_module[parts[0]], *parts[2:]), int(parts[1])
        else:
            path, layer = tuple(parts), 0
        groups.setdefault(path, []).append((layer, name))
    return {path: [n for _, n in sorted(groups[path])]
            for path in sorted(groups)}


def reference_names(model) -> List[str]:
    """``model``'s parameter names in the reference's leaf order."""
    return [n for names in _leaf_paths(model).values() for n in names]


def reference_tree(model, tensors: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict:
    """The reference's nested parameter tree of ``tensors`` (port
    parameter name -> tensor; default the model's parameters, detached),
    per-layer tensors stacked on a leading axis."""
    if tensors is None:
        tensors = {n: p.detach() for n, p in model.named_parameters()}
    stacked = _stacked(model)
    tree: Dict = {}
    for path, names in _leaf_paths(model).items():
        leaf = (torch.stack([tensors[n] for n in names])
                if path[0] in stacked else tensors[names[0]])
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return np.array(t.cpu().numpy(), copy=True)


def tree_to_numpy(tree: Mapping) -> Dict:
    """A nested mapping of tensors as numpy (bf16 as float32, exact; numpy
    leaves pass through)."""
    return {k: tree_to_numpy(v) if isinstance(v, Mapping)
            else _numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tree.items()}


def _to_numpy(model) -> Dict:
    return tree_to_numpy(reference_tree(model))


def decoder_to_numpy(model) -> Dict:
    """The reference's parameter tree of a :class:`~repro_torch.models.
    transformer.DecoderLM` (the inverse of :func:`decoder_from_numpy`)."""
    return _to_numpy(model)


def rwkv6_to_numpy(model) -> Dict:
    """The reference's parameter tree of an :class:`~repro_torch.models.
    rwkv6.RWKV6LM` (the inverse of :func:`rwkv6_from_numpy`)."""
    return _to_numpy(model)


def griffin_to_numpy(model) -> Dict:
    """The reference's parameter tree of a :class:`~repro_torch.models.
    griffin.GriffinLM` (the inverse of :func:`griffin_from_numpy`)."""
    return _to_numpy(model)


def encdec_to_numpy(model) -> Dict:
    """The reference's parameter tree of an :class:`~repro_torch.models.
    encdec.EncDecLM` (the inverse of :func:`encdec_from_numpy`)."""
    return _to_numpy(model)


def load_reference_tree(model, tree: Mapping):
    """Copy a reference-layout parameter tree (tensors or numpy leaves,
    e.g. a restored checkpoint's ``params``) into ``model``'s parameters;
    returns ``model``."""
    return _load_numpy(model, tree_to_numpy(tree), _stacked(model),
                       "load_reference_tree")


_OPT_TREES = ("master", "m", "v", "ef_residual")


def adamw_state_to_numpy(model, state: Mapping) -> Dict:
    """AdamW's state (:mod:`repro_torch.optim.adamw`, keyed by the port's
    parameter names) as the reference's tree: ``master``, ``m``, ``v``
    (and ``ef_residual``) in the parameter tree's layout, ``step`` an
    int32 scalar."""
    out = {k: tree_to_numpy(reference_tree(model, state[k]))
           for k in _OPT_TREES if k in state}
    out["step"] = np.asarray(int(state["step"]), np.int32)
    return out


def adamw_state_from_numpy(model, tree: Mapping, device="cuda") -> Dict:
    """The inverse of :func:`adamw_state_to_numpy`: float32 tensors on
    ``device`` keyed by the port's parameter names, in the reference's
    leaf order."""
    dev = resolve_device(device)
    stacked = _stacked(model)
    out: Dict = {}
    for k in _OPT_TREES:
        if k not in tree:
            continue
        flat = {}
        for path, names in _leaf_paths(model).items():
            node = tree[k]
            for part in path:
                node = node[part]
            a = np.asarray(node, dtype=np.float32)
            parts = a if path[0] in stacked else [a]
            for n, x in zip(names, parts):
                flat[n] = torch.from_numpy(np.array(x, copy=True)).to(dev)
        out[k] = flat
    out["step"] = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                               device=dev)
    return out


def _array_to_tensor(a, dev: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``dev`` in its own dtype (a numpy ``bfloat16``
    arrives bit for bit in ``torch.bfloat16``)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def griffin_state_from_numpy(state: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's griffin serving state on ``device`` from the
    reference's (``GriffinLM.prefill`` / ``init_state`` / ``decode_step``):
    every key kept, every leaf copied in its own dtype."""
    dev = resolve_device(device)
    return {name: _array_to_tensor(a, dev) for name, a in state.items()}


def encdec_state_from_numpy(state: Mapping, device="cuda") -> Dict:
    """The port's encoder-decoder serving state on ``device`` from the
    reference's: ``self`` (its ``FullKV``, through
    :func:`kv_cache_from_numpy`), ``cross_k``, ``cross_v`` and
    ``enc_positions``, each in its own dtype."""
    dev = resolve_device(device)
    out = {name: _array_to_tensor(state[name], dev)
           for name in ("cross_k", "cross_v", "enc_positions")}
    out["self"] = kv_cache_from_numpy(state["self"], device=dev)
    return out


def kv_cache_from_numpy(cache_arrays, device="cuda"):
    """The port's :class:`~repro_torch.models.kvcache.FullKV`, or
    :class:`~repro_torch.models.kvcache.SlidingKV` when ``k_pos`` is
    given, on ``device``, holding copies of the reference's cache.

    ``cache_arrays`` maps ``k``, ``v``, ``pos`` (and ``k_pos`` for the
    ring) to arrays, or is the reference's cache object itself (read by
    those attribute names through ``numpy.asarray``).  ``k`` and ``v`` keep
    their dtype (a numpy ``bfloat16`` arrives bit for bit in
    ``torch.bfloat16``); positions are int32."""
    from repro_torch.models import kvcache as kvc

    names = ("k", "v", "pos", "k_pos")
    if not isinstance(cache_arrays, Mapping):
        cache_arrays = {n: getattr(cache_arrays, n) for n in names
                        if hasattr(cache_arrays, n)}
    dev = resolve_device(device)

    def positions(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    k, v = (_array_to_tensor(cache_arrays[n], dev) for n in ("k", "v"))
    pos = positions(cache_arrays["pos"])
    if "k_pos" in cache_arrays:
        return kvc.SlidingKV(k=k, v=v, k_pos=positions(cache_arrays["k_pos"]),
                             pos=pos)
    return kvc.FullKV(k=k, v=v, pos=pos)
