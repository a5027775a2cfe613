"""Checkpoint/resume: params + optimizer state + data cursor + RNG + config.

Reference behavior (SURVEY.md section 6): per-epoch pickle/npz dumps of
params + meta; a crash loses at most one epoch. This implementation keeps
that contract but checkpoints the FULL training state (optimizer moments,
RNG key, data cursor), so resume is exact, not approximate.

Format: one ``.npz`` of flattened pytree leaves (keyed by their tree paths)
plus a JSON sidecar (step, epoch, cursor, configs, vocab hash). Arrays are
gathered to host before saving — at SERT scale (<= a few GB of embeddings)
single-file checkpoints are the right tradeoff; sharded-per-chip
serialization would only matter past host memory, out of scope per SURVEY.

Multi-host safety (SURVEY.md section 6, failure row: "multi-host runs
restart from latest complete checkpoint"): on a multi-controller pod,
(1) leaves that are not fully addressable from this process are gathered
with ``multihost_utils.process_allgather`` — a COLLECTIVE every process
must enter; (2) only process 0 writes the files (one atomic rename, no
cross-process path races); (3) a named barrier keys on the step so no
process resumes training before the checkpoint is complete on disk.
Restart procedure: relaunch all processes with the same ckpt_dir on shared
(or process-0-local + distributed-fs) storage; every process loads the
same ckpt via load_checkpoint and re-places it onto its mesh with
parallel.sharding.shard_state (the train loop does this via its state
template). Single-process runs skip all three steps.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

_CKPT_RE = re.compile(r"ckpt-(\d+)\.npz$")


def _is_prng_key(leaf: Any) -> bool:
    return (hasattr(leaf, "dtype")
            and jax.numpy.issubdtype(leaf.dtype, jax.dtypes.prng_key))


def _to_host(leaf: Any) -> np.ndarray:
    """Full global value of a (possibly sharded) array on THIS host.

    Fully-addressable arrays (single-process, however many local devices)
    assemble via device_get. Non-fully-addressable arrays (multi-host pod:
    this process holds only its shards) are gathered with the
    process_allgather COLLECTIVE — every process must call _flatten before
    any returns, which save_checkpoint's structure guarantees."""
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
    return np.asarray(jax.device_get(leaf))


def _storable(arr: np.ndarray) -> np.ndarray:
    """npz-roundtrippable view of a host array.

    np.savez silently degrades ml_dtypes dtypes (bfloat16) to raw void
    ('|V2'), which np.load returns un-castable — a bf16-params checkpoint
    would save fine and then be UNLOADABLE. Store such arrays as a
    same-width uint view; _unflatten views them back through the template
    leaf's dtype (which is the single source of dtype truth either way)."""
    if arr.dtype.kind == "V":                # ml_dtypes extension dtypes
        if arr.dtype.itemsize == 2:          # bfloat16
            return arr.view(np.uint16)
        if arr.dtype.itemsize == 1:          # fp8 family, should it appear
            return arr.view(np.uint8)
    return arr


def _flatten(tree: Any, keep=None) -> Dict[str, np.ndarray]:
    """``keep(keystr) -> bool`` filters BEFORE the device->host fetch —
    that ordering is the point of params-only snapshots: the optimizer
    moments (2/3 of an adam state's bytes) never cross the host link."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        if keep is not None and not keep(key):
            continue
        if _is_prng_key(leaf):
            # Typed PRNG keys serialize as their uint32 key data.
            flat[key] = _to_host(jax.random.key_data(leaf))
        else:
            flat[key] = _storable(_to_host(leaf))
    return flat


def _params_only_keep(key: str) -> bool:
    return key.startswith(".params") or key == ".step"


def _barrier(name: str) -> None:
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def _unflatten(template: Any, flat: Dict[str, np.ndarray],
               allow_missing: bool = False) -> Any:
    """Template leaves only provide shape/dtype — live arrays are NOT copied
    to host (that would round-trip the whole state) and abstract
    ShapeDtypeStructs (from jax.eval_shape) work equally well.

    ``allow_missing`` (params-only snapshots): leaves absent from the
    file keep the TEMPLATE leaf verbatim — a ShapeDtypeStruct from
    eval_shape stays abstract, which is fine for consumers that only read
    ``.params`` (scoring, sweep). Resume paths must not load such files
    (latest_checkpoint(full_only=True))."""
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, leaf in paths_leaves:
        key = jax.tree_util.keystr(path)
        if key not in flat:
            if allow_missing:
                leaves.append(leaf)
                continue
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if _is_prng_key(leaf):
            data = jax.numpy.asarray(arr)
            try:
                impl = jax.random.key_impl(leaf)
                leaves.append(jax.random.wrap_key_data(data, impl=impl))
            except (TypeError, AttributeError):  # abstract template leaf
                leaves.append(jax.random.wrap_key_data(data))
            continue
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key} shape {arr.shape} != expected "
                f"{tuple(leaf.shape)}")
        want = np.dtype(leaf.dtype)
        if (want.kind == "V" and arr.dtype.kind in ("u", "V")
                and arr.dtype.itemsize == want.itemsize):
            # Extension dtypes (bfloat16) travel as a same-width uint
            # carrier (_storable) — or raw void in legacy files. Restore
            # by BIT REINTERPRETATION: astype would numerically convert
            # the carrier integers into garbage values.
            leaves.append(arr.view(want))
        else:
            leaves.append(arr.astype(want))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _cast_params(state: Any, dtype_name: str) -> Any:
    """Cast floating ``.params`` leaves ON DEVICE (HBM->HBM, milliseconds).

    Ordering is the point: the cast runs BEFORE the device->host fetch in
    _flatten, so a bfloat16 snapshot moves HALF the bytes over the host
    link. Non-float leaves and host arrays pass through untouched."""
    import jax.numpy as jnp
    dt = jnp.dtype(dtype_name)

    def cast(leaf):
        if (isinstance(leaf, jax.Array)
                and jnp.issubdtype(leaf.dtype, jnp.floating)
                and leaf.dtype != dt):
            return leaf.astype(dt)
        return leaf

    if hasattr(state, "_replace") and hasattr(state, "params"):
        return state._replace(params=jax.tree.map(cast, state.params))
    return state


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    meta: Optional[Dict] = None,
                    max_to_keep: int = 0,
                    params_only: bool = False,
                    params_dtype: Optional[str] = None) -> str:
    """Write ckpt-{step}.npz + ckpt-{step}.json atomically (tmp + rename).

    ``max_to_keep > 0`` prunes the oldest checkpoints beyond that count
    (the reference kept every epoch snapshot; epoch-level keeps are cheap,
    but step-level checkpointing wants a bound).

    ``params_only``: store just ``.params`` + ``.step`` — the reference's
    own per-epoch dump format (SURVEY.md section 3.1: "pickle/numpy dump
    of all model params + meta per epoch"), and 1/3 the bytes of an adam
    full state. The optimizer leaves never leave the device. Such files
    serve scoring/sweep but NOT resume (latest_checkpoint full_only).

    ``params_dtype`` (params_only files only): storage dtype for the param
    leaves — "bfloat16" halves both the device->host fetch and the disk
    bytes (TrainConfig.snapshot_dtype). The sidecar records it so
    load_checkpoint can restore the carrier view before the template cast.

    Multi-host: collective — every process must call with the same step
    (see module docstring); only process 0 touches the filesystem, and all
    processes return after the write-complete barrier."""
    multi = jax.process_count() > 1
    base = os.path.join(ckpt_dir, f"ckpt-{step:08d}")
    keep = _params_only_keep if params_only else None
    narrow = (params_only and params_dtype
              and params_dtype != "float32")
    if narrow:
        state = _cast_params(state, params_dtype)
    flat = _flatten(state, keep)  # collective on a pod: all processes enter
    if multi and jax.process_index() != 0:
        _barrier(f"ckpt-{step}")  # wait for process 0's atomic rename
        return base + ".npz"
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = base + ".npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    # Sidecar FIRST, npz rename as the commit point: discovery keys on the
    # .npz (latest_checkpoint), so a crash between the two renames must
    # leave an orphan .json (harmless), never a discoverable checkpoint
    # with empty meta — that would resume at epoch 0 and skip the
    # vocab-hash guard.
    extra = {"params_only": True} if params_only else {}
    if narrow:
        extra["snapshot_dtype"] = params_dtype
    with open(base + ".json.tmp", "w") as fh:
        json.dump({"step": int(step), **extra, **(meta or {})}, fh, indent=2)
    os.replace(base + ".json.tmp", base + ".json")
    os.replace(tmp, base + ".npz")
    if max_to_keep > 0:
        existing = list_checkpoints(ckpt_dir)
        # Never evict the NEWEST FULL checkpoint: with params-only epoch
        # snapshots in the mix, oldest-first pruning could otherwise
        # delete the run's only resume point.
        newest_full = None
        for s in sorted(existing, reverse=True):
            if not load_meta(existing[s]).get("params_only"):
                newest_full = s
                break
        for old_step in sorted(existing)[:-max_to_keep]:
            if old_step == newest_full:
                continue
            os.remove(existing[old_step])
            j = existing[old_step][:-len(".npz")] + ".json"
            if os.path.exists(j):
                os.remove(j)
    if multi:
        _barrier(f"ckpt-{step}")  # release the other processes
    return base + ".npz"


def rewrite_meta(ckpt_dir: str, step: int, meta: Optional[Dict]) -> str:
    """Atomically replace an EXISTING checkpoint's JSON sidecar.

    The epoch-end snapshot and a step-aligned mid-epoch save land on the
    same ckpt-{step} path with identical params — only the meta (epoch,
    cursor) differs. Rewriting the sidecar upgrades the mid-epoch save to
    the epoch snapshot without re-fetching and re-writing the multi-GB
    npz. Multi-host: collective, same contract as save_checkpoint."""
    multi = jax.process_count() > 1
    base = os.path.join(ckpt_dir, f"ckpt-{step:08d}")
    if multi and jax.process_index() != 0:
        _barrier(f"ckpt-meta-{step}")
        return base + ".npz"
    if not os.path.exists(base + ".npz"):
        raise FileNotFoundError(f"no checkpoint to rewrite at {base}.npz")
    with open(base + ".json.tmp", "w") as fh:
        json.dump({"step": int(step), **(meta or {})}, fh, indent=2)
    os.replace(base + ".json.tmp", base + ".json")
    if multi:
        _barrier(f"ckpt-meta-{step}")
    return base + ".npz"


def _device_copy(tree: Any) -> Any:
    """Fresh device buffers for every array leaf (shardings preserved).

    The train step DONATES its input state, so a state handed to a
    background writer must not share buffers with the live one — the next
    step would invalidate them mid-fetch."""
    def cp(leaf):
        if _is_prng_key(leaf):
            data = jax.numpy.copy(jax.random.key_data(leaf))
            return jax.random.wrap_key_data(data,
                                            impl=jax.random.key_impl(leaf))
        if isinstance(leaf, jax.Array):
            return jax.numpy.copy(leaf)
        return leaf
    return jax.tree.map(cp, tree)


class AsyncCheckpointer:
    """Overlap the slow device->host state fetch + npz write with training.

    A 1M-entity LSE training state is ~1.9 GB with adam moments; a
    synchronous per-epoch snapshot would stall training for the whole
    fetch + write. Here the state is copied on-device
    first (HBM->HBM, ~milliseconds) and a single worker thread runs the
    fetch + atomic write while the next epoch trains. At most one save is
    in flight — a second `save` joins the first — bounding the extra HBM
    footprint to one state copy.

    Multi-process runs degrade to SYNCHRONOUS saves: _flatten is a
    collective there (process_allgather) and must run in program order on
    the main thread of every process. Worker exceptions re-raise on the
    next save()/wait().
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, ckpt_dir: str, step: int, state: Any,
             meta: Optional[Dict] = None, max_to_keep: int = 0,
             sync: bool = False, params_only: bool = False,
             params_dtype: Optional[str] = None) -> None:
        if sync or jax.process_count() > 1:
            self.wait()
            save_checkpoint(ckpt_dir, step, state, meta,
                            max_to_keep=max_to_keep, params_only=params_only,
                            params_dtype=params_dtype)
            return
        self.wait()                      # serialize; re-raise prior failure
        if params_only and hasattr(state, "_replace"):
            # Don't hold an HBM copy of the optimizer moments (2/3 of an
            # adam state) for the whole async write when the keep filter
            # would discard them anyway. keystr paths of .params/.step
            # are unaffected by emptying the sibling fields.
            state = state._replace(opt_state=(), rng=None)
        if params_only and params_dtype and params_dtype != "float32":
            # Cast BEFORE the copy: astype already allocates fresh buffers
            # (donation-safe, same as _device_copy) at HALF the HBM
            # footprint of holding an fp32 copy for the whole async write.
            state = _cast_params(state, params_dtype)
        snap = _device_copy(state)

        def work() -> None:
            try:
                save_checkpoint(ckpt_dir, step, snap, meta,
                                max_to_keep=max_to_keep,
                                params_only=params_only,
                                params_dtype=params_dtype)
            except BaseException as exc:
                self._err = exc

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"ckpt-writer-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def latest_checkpoint(ckpt_dir: str, full_only: bool = False
                      ) -> Optional[str]:
    """Newest checkpoint path. ``full_only`` skips params-only epoch
    snapshots (sidecar flag) — resume needs the optimizer state."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            steps.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    for _, path in sorted(steps, reverse=True):
        if full_only and load_meta(path).get("params_only"):
            continue
        return path
    return None


def list_checkpoints(ckpt_dir: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _CKPT_RE.match(name)
            if m:
                out[int(m.group(1))] = os.path.join(ckpt_dir, name)
    return dict(sorted(out.items()))


def load_meta(path: str) -> Dict:
    """Read a checkpoint's JSON sidecar without touching the npz (cheap
    cursor/hash inspection — sweep uses this to skip checkpoints unloaded)."""
    meta_path = path[:-len(".npz")] + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            return json.load(fh)
    return {}


def load_checkpoint(path: str, template: Any) -> Tuple[Any, Dict]:
    """Restore a state pytree (shaped like ``template``) + the JSON meta.

    Params-only snapshots (sidecar ``params_only``) fill ``.params`` and
    ``.step`` and leave the other template leaves verbatim — valid for
    scoring/sweep, never handed to resume (the loop restricts resume
    discovery to full checkpoints).

    Narrow-dtype snapshots (sidecar ``snapshot_dtype``, e.g. "bfloat16"):
    the param floats traveled as a same-width uint carrier (_storable);
    view them back through the RECORDED dtype first, then _unflatten's
    template cast widens to whatever the consumer runs (fp32 template ->
    numeric bf16->fp32 cast; bf16 template -> no-op view). Without this
    step the uint16 carrier would be numerically cast into garbage."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = load_meta(path)
    sdt = meta.get("snapshot_dtype")
    if sdt and sdt != "float32":
        import ml_dtypes
        dt = np.dtype(getattr(ml_dtypes, sdt))
        for k, arr in flat.items():
            if (k.startswith(".params") and arr.dtype.kind == "u"
                    and arr.dtype.itemsize == dt.itemsize):
                flat[k] = arr.view(dt)
    return _unflatten(template, flat,
                      allow_missing=bool(meta.get("params_only"))), meta


def has_sparse_opt_state(path: str) -> bool:
    """True when the checkpoint was written by the row-sparse lazy-update
    step (train/sparse.py: opt_state = {"dense": ..., "rows": ...}) rather
    than a dense optax state. Reads only the npz directory, not the arrays.

    Loaders use this to build a template whose opt_state flavor MATCHES the
    file: ``sparse_update="auto"`` resolves from the live config, so a
    checkpoint written before the sparse path existed (or with it off) must
    not be forced through a sparse-shaped template (and vice versa)."""
    with np.load(path) as z:
        return any(k.startswith(".opt_state['dense']") for k in z.files)
