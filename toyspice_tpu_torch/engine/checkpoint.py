"""Checkpoint / resume for transient state (engine/checkpoint.py of the JAX
package, with the same file layout, so a checkpoint written by either
package loads in the other).

The reference has no checkpointing: device state lives in struct fields and
dies with the process.  Here the committed transient state is one dict of
arrays, so a checkpoint is one flat ``.npz``: ``kind/key`` for the state,
``__jv__/kind/key`` for the junction voltages, ``__meta__/key`` for scalar
metadata.  A resumed run continues exactly, because the engine's state IS
the checkpoint::

    fn = make_tran_batch(cc, cfg, axes)
    out = fn(params, init_state(cc))
    save_checkpoint("ckpt.npz", out.state, jv=out.jv, t=out.t_final,
                    dt=out.dt_final)
    state, jv, meta = load_checkpoint("ckpt.npz", cc, device="cuda")
    more = make_tran_batch(cc, cfg2, axes, resume=True)
    out2 = more(params, state, meta["t"], jv, meta["dt"])

Monte-Carlo batches checkpoint the same way: the leaves carry the leading
batch axis.
"""

from typing import Dict, Optional, Tuple

import numpy as np

_META_PREFIX = "__meta__/"
_JV_PREFIX = "__jv__/"


def _numpy(val):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(val, "detach"):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def save_checkpoint(path: str, state: Dict, jv: Optional[Dict] = None,
                    **meta) -> None:
    """Write a state dict-of-dicts of tensors or arrays, the optional
    junction voltages ``jv`` (needed to resume a nonlinear deck without an
    OP), and metadata such as ``t=out.t_final``."""
    flat = {}
    for kind, tbl in state.items():
        for key, val in tbl.items():
            flat[f"{kind}/{key}"] = _numpy(val)
    for kind, tbl in (jv or {}).items():
        for key, val in tbl.items():
            flat[f"{_JV_PREFIX}{kind}/{key}"] = _numpy(val)
    for key, val in meta.items():
        flat[_META_PREFIX + key] = _numpy(val)
    np.savez(path, **flat)


def load_checkpoint(path: str, cc=None, fill_missing: bool = False,
                    device=None) -> Tuple[Dict, Optional[Dict], Dict]:
    """Read (state, jv, meta); jv is None if the checkpoint carries none.
    With a compiled circuit, check that the checkpoint's structure and
    shapes match the circuit's state template (one leading batch axis
    allowed); ``fill_missing=True`` fills state fields absent from the file
    with the template's zeros.  With ``device``, the state and jv leaves
    come back as f64 tensors there (the form the port's entry points
    take); else as numpy arrays."""
    with np.load(path) as data:
        state: Dict = {}
        jv: Dict = {}
        meta: Dict = {}
        for key in data.files:
            if key.startswith(_META_PREFIX):
                meta[key[len(_META_PREFIX):]] = data[key][()]
                continue
            if key.startswith(_JV_PREFIX):
                kind, field = key[len(_JV_PREFIX):].split("/", 1)
                jv.setdefault(kind, {})[field] = data[key]
                continue
            kind, field = key.split("/", 1)
            state.setdefault(kind, {})[field] = data[key]

    if cc is not None:
        from .state import init_state

        template = {kind: {f: _numpy(v) for f, v in tbl.items()}
                    for kind, tbl in init_state(cc, device="cpu").items()}
        t_keys = {(k, f) for k, tbl in template.items() for f in tbl}
        s_keys = {(k, f) for k, tbl in state.items() for f in tbl}
        if fill_missing:
            for kind, field in t_keys - s_keys:
                state.setdefault(kind, {})[field] = template[kind][field]
            s_keys = {(k, f) for k, tbl in state.items() for f in tbl}
        if t_keys != s_keys:
            missing = t_keys - s_keys
            extra = s_keys - t_keys
            raise ValueError(
                f"checkpoint does not match circuit: missing="
                f"{sorted(missing)} extra={sorted(extra)} (fill_missing="
                "True zero-fills fields added after the checkpoint was "
                "written)")
        for kind, tbl in template.items():
            for field, val in tbl.items():
                got = state[kind][field].shape
                want = val.shape
                if got != want and got[1:] != want:
                    raise ValueError(
                        f"checkpoint shape mismatch for {kind}/{field}: "
                        f"{got} vs circuit {want}")
    if device is not None:
        import torch

        def tensors(tree):
            return {kind: {f: torch.as_tensor(np.asarray(v, np.float64),
                                              device=device)
                           for f, v in tbl.items()}
                    for kind, tbl in tree.items()}

        state, jv = tensors(state), tensors(jv)
    return state, (jv or None), meta
