"""Carry parameter and state pytrees across from numpy.

The JAX package's ``engine/batch.batch_params`` returns a nested dict
``{kind: {key: array}}``.  Converted leaf by leaf with ``np.asarray`` it
becomes the input of ``params_from_numpy``, which gives the port's form: the
same dict of f64 tensors on one device, shared leaves (nk,) and batched
leaves (B, nk) (PWL knots (nS, P) and (B, nS, P)).
"""

import numpy as np
import torch


def params_from_numpy(params, device="cuda"):
    """``batch_params``' pytree as numpy arrays -> the port's param dict
    (the leaves are copied)."""
    return {kind: {key: torch.as_tensor(np.array(leaf, dtype=np.float64),
                                        device=device)
                   for key, leaf in tbl.items()}
            for kind, tbl in params.items()}
