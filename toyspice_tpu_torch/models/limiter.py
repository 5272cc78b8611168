"""Junction-voltage limiting (SPICE3F5 DEVpnjlim), batched f64 torch.

The JAX package's ``models/limiter.py``: when a junction tries to jump past
the critical voltage by more than 2·Vt in one Newton step, pull it back
logarithmically.  Converged fixed points are unchanged.
"""

import math

import torch

SQRT2 = math.sqrt(2.0)


def vcrit(vte, is_):
    """Critical voltage vte·ln(vte/(√2·Is))."""
    return vte * torch.log(vte / (SQRT2 * is_))


def pnjlim(vnew, vold, vte, vc):
    """SPICE3F5 DEVpnjlim:

    if vnew > vcrit and |vnew - vold| > 2·vte:
        vold > 0:  vnew = vold + vte·ln(1 + (vnew-vold)/vte)   (arg>0)
                   vnew = vcrit                                 (arg<=0)
        vold <= 0: vnew = vte·ln(vnew/vte)
    """
    limit = (vnew > vc) & ((vnew - vold).abs() > 2.0 * vte)
    arg = 1.0 + (vnew - vold) / vte
    pos = torch.where(arg > 0, vold + vte * torch.log(arg.clamp_min(1e-300)),
                      vc)
    neg = vte * torch.log(vnew.clamp_min(1e-300) / vte)
    limited = torch.where(vold > 0, pos, neg)
    return torch.where(limit, limited, vnew)
