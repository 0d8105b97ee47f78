"""``.npz`` checkpoints in the JAX package's format, with numpy alone.

The counterpart of ``building_detection_tpu/train/checkpoint.py`` (its
``.npz`` half).  A checkpoint holds flat keys ``params||<name>`` and
``state||<name>`` (JAX layouts, as :func:`core.module.jax_variables` gives
them), the optimizer state as ``opt||<key>`` in the JAX package's
flattening (``opt||.count``, ``opt||.mu['<name>']``, ``opt||.nu['<name>']``;
:meth:`train.optim.KerasAdam.jax_state`), ``meta||step`` and, optionally,
``meta||json`` as uint8 bytes.  Either package restores what the other
wrote.

The Keras ``.h5`` half (:func:`import_h5_weights`, :func:`export_h5_weights`)
works on the same flat JAX-layout dicts, so a file either package writes
imports in the other.  It reads and writes the files through
:mod:`utils.hdf5`, with numpy alone: it reads what h5py writes (its default
format and ``libver='latest'``) and writes h5py's default format, the one
TF-Keras reads.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from building_detection_tpu_torch.utils import hdf5

SEP = "||"  # flat-key separator inside npz archives

Flat = Dict[str, np.ndarray]


def save_variables(
    path: str,
    params: Mapping[str, np.ndarray],
    state: Mapping[str, np.ndarray],
    opt_state: Optional[Mapping[str, np.ndarray]] = None,
    step: int = 0,
    metadata: Optional[dict] = None,
) -> None:
    """Write a checkpoint atomically (a temporary file, then a rename);
    ``path`` should end in ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {f"params{SEP}{k}": np.asarray(v) for k, v in params.items()}
    payload.update({f"state{SEP}{k}": np.asarray(v) for k, v in state.items()})
    for k, v in (opt_state or {}).items():
        payload[f"opt{SEP}{k}"] = np.asarray(v)
    payload[f"meta{SEP}step"] = np.asarray(step)
    if metadata:
        payload[f"meta{SEP}json"] = np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_variables(path: str) -> Tuple[Flat, Flat, Flat, int, dict]:
    """Read ``(params, state, opt_state, step, metadata)``; ``opt_state`` is
    the flat ``{'.count': ..., ".mu['<name>']": ...}`` dict (empty when the
    checkpoint has none)."""
    params: Flat = {}
    state: Flat = {}
    opt: Flat = {}
    step, meta = 0, {}
    with np.load(path) as z:
        for key in z.files:
            kind, name = key.split(SEP, 1)
            if kind == "params":
                params[name] = z[key]
            elif kind == "state":
                state[name] = z[key]
            elif kind == "opt":
                opt[name] = z[key]
            elif kind == "meta" and name == "step":
                step = int(z[key])
            elif kind == "meta" and name == "json":
                meta = json.loads(z[key].tobytes().decode())
    return params, state, opt, step, meta


def check_matches_model(
    path: str,
    loaded_params: Mapping[str, np.ndarray],
    loaded_state: Mapping[str, np.ndarray],
    template_params: Mapping[str, np.ndarray],
    template_state: Mapping[str, np.ndarray],
    model_name: str,
) -> None:
    """Key sets and per-key shapes (JAX layouts) must match exactly, so a
    wrong-model ``.npz`` fails loudly instead of half-applying.  Raises
    ``ValueError`` naming the first mismatch."""
    for kind, theirs, ours in (
        ("params", loaded_params, template_params),
        ("state", loaded_state, template_state),
    ):
        if set(theirs) != set(ours):
            missing = sorted(set(ours) - set(theirs))[:3]
            extra = sorted(set(theirs) - set(ours))[:3]
            raise ValueError(
                f"{path} does not match model {model_name!r} ({kind} keys differ; "
                f"missing e.g. {missing}, unexpected e.g. {extra})"
            )
        for k in ours:
            if tuple(np.shape(theirs[k])) != tuple(np.shape(ours[k])):
                raise ValueError(
                    f"{path}: {kind}[{k!r}] shape {tuple(np.shape(theirs[k]))} "
                    f"!= model's {tuple(np.shape(ours[k]))}"
                )


# ---------------------------------------------------------------------------
# Keras .h5 import/export (the reference's deployment format)
# ---------------------------------------------------------------------------
# Keras' order of the weights inside one layer: ``layer.weights`` is the
# trainable weights, then the non-trainable ones, in the layer's build order.
_KERAS_WEIGHT_RANK = {
    "kernel": 0,
    "depthwise_kernel": 0,
    "pointwise_kernel": 1,
    "gamma": 0,
    "beta": 1,
    "bias": 2,
    "moving_mean": 3,
    "moving_variance": 4,
}


def _decode(n):
    return n.decode() if isinstance(n, bytes) else n


@dataclasses.dataclass
class H5ImportReport:
    """What an ``.h5`` import did.  ``name_pass_rejected`` says why the
    all-or-nothing name pass was abandoned; it is a diagnostic and does not
    make the import incomplete (the order pass may still match everything)."""

    matched_by_name: int = 0
    matched_by_order: int = 0
    unmatched_ours: list = dataclasses.field(default_factory=list)
    leftover_h5: list = dataclasses.field(default_factory=list)
    name_pass_rejected: str = ""

    @property
    def complete(self) -> bool:
        return not (self.unmatched_ours or self.leftover_h5)

    def summary(self) -> str:
        lines = [f"h5 import: {self.matched_by_name} matched by name, {self.matched_by_order} by order"]
        if self.name_pass_rejected:
            lines.append(f"  name pass rejected: {self.name_pass_rejected}")
        if self.unmatched_ours:
            lines.append(
                f"  UNMATCHED TARGET PARAMS ({len(self.unmatched_ours)}, left at previous values): "
                + ", ".join(self.unmatched_ours[:10])
                + ("..." if len(self.unmatched_ours) > 10 else "")
            )
        if self.leftover_h5:
            lines.append(
                f"  LEFTOVER H5 WEIGHTS ({len(self.leftover_h5)}, dropped): "
                + ", ".join(self.leftover_h5[:10])
                + ("..." if len(self.leftover_h5) > 10 else "")
            )
        return "\n".join(lines)


def _read_h5_entries(h5_path: str) -> List[Tuple[str, str, str, np.ndarray]]:
    """Ordered ``(layer name, weight suffix, full name, array)`` of a Keras
    weights file: layers in the ``layer_names`` attribute's order (Keras
    writes ``model.layers`` order), weights in each layer's ``weight_names``
    order.  Depthwise kernels come back in the JAX layout."""
    entries = []
    with hdf5.File(h5_path) as f:
        root = f["model_weights"] if "model_weights" in f else f
        for lname in (_decode(n) for n in root.attrs.get("layer_names", list(root.keys()))):
            g = root[lname]
            for wn in (_decode(w) for w in g.attrs.get("weight_names", [])):
                arr = np.asarray(g[wn][()])
                suffix = wn.rsplit("/", 1)[-1].split(":")[0]
                if suffix == "depthwise_kernel" and arr.ndim == 4:
                    # Keras (kh, kw, in_ch, 1) -> JAX (kh, kw, 1, in_ch)
                    arr = np.ascontiguousarray(arr.transpose(0, 1, 3, 2))
                # the layer scope in the weight's path is the name to match on
                layer = wn.rsplit("/", 2)[-2] if "/" in wn else lname
                entries.append((layer, suffix, f"{lname}/{wn}", arr))
    return entries


def import_h5_weights(
    h5_path: str,
    params: Mapping[str, np.ndarray],
    state: Mapping[str, np.ndarray],
    strict: bool = True,
) -> Tuple[Flat, Flat, H5ImportReport]:
    """Map a Keras weights-only ``.h5`` onto flat JAX-layout ``(params,
    state)`` dicts, which must be in construction order (as
    :func:`core.module.jax_variables` gives them).  Two passes:

    1. **by name, all or nothing**: ``conv2d_5/kernel:0`` is
       ``conv2d_5/kernel``.  Taken only when the names cover every target
       and use every ``.h5`` weight with agreeing shapes: a file written
       with offset Keras name counters holds names that collide with other
       layers', so a partial name match would load wrong weights silently;
    2. **by order** otherwise: each target, in construction order, takes
       the first unused ``.h5`` weight of its suffix and shape, which is how
       Keras' own ``load_weights`` resolves a file (and separates the 16
       shape-identical Xception middle-flow blocks).

    Transposed-conv kernels keep TF's ``(kh, kw, out, in)`` layout and move
    unchanged; depthwise kernels swap their last two axes (exact: one of
    them has size 1).  ``strict=True`` raises ``ValueError`` with the report
    unless every target is assigned and every ``.h5`` weight used;
    ``strict=False`` leaves unmatched targets at their values.
    """
    entries = _read_h5_entries(h5_path)
    new_params, new_state = dict(params), dict(state)
    report = H5ImportReport()
    ours = [(k, "params") for k in params] + [(k, "state") for k in state]
    targets = {**params, **state}

    def assign(key: str, kind: str, arr: np.ndarray) -> None:
        dest = new_params if kind == "params" else new_state
        dest[key] = arr.astype(np.asarray(targets[key]).dtype)

    by_name: Dict[str, int] = {}
    for idx, (layer, suffix, _, _) in enumerate(entries):
        by_name.setdefault(f"{layer}/{suffix}", idx)
    name_assign: Dict[str, int] = {}
    name_used = set()
    names_complete = len(entries) == len(ours)
    if not names_complete:
        report.name_pass_rejected = f"h5 holds {len(entries)} weights, model has {len(ours)}"
    for key, _ in ours:
        if not names_complete:
            break
        idx = by_name.get(key)
        if idx is None:
            report.name_pass_rejected = f"{key} absent from h5 names"
        elif idx in name_used:
            report.name_pass_rejected = f"{entries[idx][2]} claimed twice"
        elif tuple(entries[idx][3].shape) != tuple(np.shape(targets[key])):
            report.name_pass_rejected = (
                f"{key}: ours {tuple(np.shape(targets[key]))} != h5 {tuple(entries[idx][3].shape)}"
            )
        else:
            name_assign[key] = idx
            name_used.add(idx)
            continue
        names_complete = False

    consumed = set()
    if names_complete:
        for key, kind in ours:
            assign(key, kind, entries[name_assign[key]][3])
            consumed.add(name_assign[key])
        report.matched_by_name = len(ours)
    else:
        for key, kind in ours:
            want, shape = key.rsplit("/", 1)[-1], tuple(np.shape(targets[key]))
            for idx, (_, suffix, _, arr) in enumerate(entries):
                if idx not in consumed and suffix == want and tuple(arr.shape) == shape:
                    assign(key, kind, arr)
                    consumed.add(idx)
                    report.matched_by_order += 1
                    break
            else:
                report.unmatched_ours.append(key)

    report.leftover_h5 = [full for idx, (_, _, full, _) in enumerate(entries) if idx not in consumed]
    if strict and not report.complete:
        raise ValueError(f"strict .h5 import failed for {h5_path}:\n{report.summary()}")
    return new_params, new_state, report


def export_h5_weights(
    path: str,
    params: Mapping[str, np.ndarray],
    state: Mapping[str, np.ndarray],
    layer_order: Optional[Sequence[str]] = None,
) -> None:
    """Write flat JAX-layout ``(params, state)`` as the Keras weights-only
    ``.h5`` that ``model.save_weights`` writes: a root ``layer_names``
    attribute, one group per layer with a ``weight_names`` attribute of
    ``<layer>/<weight>:0`` paths, each layer's weights in Keras' order
    (:data:`_KERAS_WEIGHT_RANK`, whatever the dicts' order: an ``.npz`` round
    trip sorts the keys, and Keras pairs the weights in a group by
    position).

    ``layer_order`` orders the groups.  Keras' positional ``load_weights``
    pairs them with ``model.layers``, which is graph depth order, not
    construction order; :func:`models.registry.keras_layer_order` gives it
    for a zoo model.  Without it the groups keep construction order, which
    :func:`import_h5_weights` reads either way.
    """
    layer_weights: Dict[str, list] = {}
    for key, arr in list(params.items()) + list(state.items()):
        layer_weights.setdefault(key.rsplit("/", 1)[0], []).append((key, arr))
    for weights in layer_weights.values():
        weights.sort(key=lambda kv: _KERAS_WEIGHT_RANK[kv[0].rsplit("/", 1)[1]])
    if layer_order is not None:
        ours, want = set(layer_weights), set(layer_order)
        if ours != want:
            raise ValueError(
                "layer_order does not match the checkpoint's layers "
                f"(missing from checkpoint: {sorted(want - ours)[:5]}, "
                f"not in layer_order: {sorted(ours - want)[:5]})"
            )
        layer_weights = {ln: layer_weights[ln] for ln in layer_order}

    with hdf5.Writer(path) as f:
        f.attrs["layer_names"] = [ln.encode() for ln in layer_weights]
        f.attrs["backend"] = b"tensorflow"
        # without keras_version, tf_keras reads the file as Keras 1 and
        # transposes Conv2DTranspose kernels; any 2.x value avoids that
        f.attrs["keras_version"] = b"2.21.0"
        for lname, weights in layer_weights.items():
            g = f.create_group(lname)
            wnames = []
            for key, arr in weights:
                wn = f"{key}:0"
                wnames.append(wn.encode())
                arr = np.asarray(arr)
                if key.endswith("/depthwise_kernel") and arr.ndim == 4:
                    # JAX (kh, kw, 1, in_ch) -> Keras (kh, kw, in_ch, 1)
                    arr = np.ascontiguousarray(arr.transpose(0, 1, 3, 2))
                g.create_dataset(wn, data=arr)
            g.attrs["weight_names"] = wnames
