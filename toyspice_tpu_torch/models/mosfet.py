"""MOSFET levels 1-3 (reference pkg/device/mosfet.go), batched f64 torch:
the JAX package's ``models/mosfet.py``.

Every instance evaluates the three levels and selects by its level code
(circuit metadata, ``cc.idx["M"]["level"]``).  Levels 2/3 take their
conductances by numeric differencing (delta = 1e-6, mosfet.go:517-532);
gmbs uses the current gm (the JAX package's documented deviation from the
reference's previous-iteration gm).  Voltages are in the type-positive
frame (PMOS flipped), as the reference stores them.
"""

from typing import NamedTuple

import torch

from ..utils.tensor import scalar_div, true_div

CUTOFF, LINEAR, SATURATION = 0, 1, 2
GMIN = 1e-12
DELTA = 1e-6
INV_DELTA = 1e6  # XLA folds a division by DELTA into this product
EPS0 = 8.85e-14  # F/cm, as the reference writes it (mosfet.go:382)


class MosEval(NamedTuple):
    id: torch.Tensor
    region: torch.Tensor
    gm: torch.Tensor
    gds: torch.Tensor
    gmbs: torch.Tensor
    cgs: torch.Tensor
    cgd: torch.Tensor
    cgb: torch.Tensor
    cbs_eff: torch.Tensor
    cbd_eff: torch.Tensor


def pow_pos(a, b):
    """a ** b for a > 0, as exp(b·log a): the form csrc/newton.cuh computes
    too.  CUDA's pow built without FMA contraction (as the kernels are)
    does not round as torch.pow does on every input, and the level-2/3
    differencing turns that last ulp into 1e-9 of a conductance; exp and
    log round alike in both builds."""
    return torch.exp(b * torch.log(a))


def terminal_voltages(p, vnl, nodes):
    """vgs, vds, vbs (flipped for PMOS) per UpdateVoltages
    (mosfet.go:640-665).  ``vnl`` (..., np1); ``nodes`` (nM, 4) columns
    drain, gate, source, bulk (host numpy or a long tensor on vnl's
    device)."""
    nodes = torch.as_tensor(nodes, dtype=torch.long, device=vnl.device)
    vd = vnl[..., nodes[:, 0]]
    vg = vnl[..., nodes[:, 1]]
    vs = vnl[..., nodes[:, 2]]
    vb = vnl[..., nodes[:, 3]]
    s = p["sign"]
    return s * (vg - vs), s * (vd - vs), s * (vb - vs)


def cold_start(p, vgs, vds, vbs):
    """All-zero bias -> the typical bias guess (mosfet.go:678-690), +0.7 /
    +0.1 / 0 in the type-positive frame for both types."""
    cold = (vgs == 0.0) & (vds == 0.0) & (vbs == 0.0)
    return (torch.where(cold, 0.7, vgs), torch.where(cold, 0.1, vds),
            torch.where(cold, 0.0, vbs))


def _vth(p, vbs_pos):
    """Threshold with body effect in the type-positive frame
    (mosfet.go:296-318)."""
    vth = p["vto"] + p["gamma"] * (
        torch.sqrt(torch.clamp_min(p["phi"] - vbs_pos, 0.0))
        - torch.sqrt(p["phi"]))
    return torch.where(p["gamma"] > 0, vth, p["vto"])


def _ids_pos(p, level, vgs, vds, vbs):
    """Drain current in the type-positive frame; returns (id, region)
    (mosfet.go:321-459, the reference's unit quirks verbatim)."""
    vth = _vth(p, vbs)
    vgst = vgs - vth
    beta1 = p["kp"] * p["w"] / p["l"]

    # level 1 (mosfet.go:358-375)
    lin1 = beta1 * (vgst * vds - 0.5 * vds * vds) * (1.0 + p["lam"] * vds)
    sat1 = 0.5 * beta1 * vgst * vgst * (1.0 + p["lam"] * vds)
    id1 = torch.where(vds < vgst, lin1, sat1)
    reg1 = torch.where(vds < vgst, LINEAR, SATURATION)

    # level 2 (mosfet.go:378-418)
    cox = scalar_div(3.9 * EPS0, p["tox"])
    tox100 = p["tox"] * 100.0
    eeff = vgst / tox100
    # eeff / ucrit as XLA computes it: (a / b) / c -> a / (b·c)
    ueff = p["uo"] / torch.where(
        (p["ucrit"] > 0) & (eeff > 0),
        1.0 + pow_pos(torch.clamp_min(vgst / (tox100 * p["ucrit"]), 1e-300),
                      p["uexp"]),
        1.0)
    ecrit = p["vmax"] / torch.where(ueff == 0, 1.0, ueff) * 100.0
    vdsat2 = torch.where(p["vmax"] > 0, torch.minimum(vgst, ecrit * p["l"]),
                         vgst)
    beta2 = ueff * cox * p["w"] / (p["l"] * 100.0)
    lin2 = beta2 * (vgst * vds - 0.5 * vds * vds) * (1.0 + p["lam"] * vds)
    sat2 = 0.5 * beta2 * vdsat2 * vdsat2 * (1.0 + p["lam"] * vds)
    id2 = torch.where(vds < vdsat2, lin2, sat2)
    reg2 = torch.where(vds < vdsat2, LINEAR, SATURATION)

    # level 3 (mosfet.go:421-459)
    vgst_eff = torch.where(p["theta"] > 0, vgst / (1.0 + p["theta"] * vgst),
                           vgst)
    # a / sqrt(b) as XLA computes it, a times the reciprocal square root
    vdsat3 = torch.where(
        p["kappa"] > 0,
        vgst_eff * scalar_div(1.0, torch.sqrt(torch.clamp_min(
            1.0 + p["kappa"] * vgst_eff, 1e-30))),
        vgst_eff)
    # beta1 / c as XLA computes it: (kp·w / l) / c -> kp·w / (l·c)
    beta3 = (p["kp"] * p["w"]) / (p["l"] * torch.where(
        p["delta"] > 0, 1.0 + p["delta"] / p["w"], 1.0))
    lin3 = (beta3
            * (vgst_eff * vds
               - 0.5 * vds * vds / (1.0 + p["kappa"] * vgst_eff))
            * (1.0 + p["lam"] * vds))
    sat3 = 0.5 * beta3 * vdsat3 * vdsat3 * (1.0 + p["lam"] * vds)
    id3 = torch.where(vds < vdsat3, lin3, sat3)
    reg3 = torch.where(vds < vdsat3, LINEAR, SATURATION)

    idl = torch.where(level == 2, id2, torch.where(level == 3, id3, id1))
    regl = torch.where(level == 2, reg2, torch.where(level == 3, reg3, reg1))
    cutoff = vgst <= 0
    return (torch.where(cutoff, 0.0, idl),
            torch.where(cutoff, CUTOFF, regl))


def dc_eval(p, level, vgs, vds, vbs) -> MosEval:
    """Current, region, conductances and Meyer capacitances at the stored
    (type-flipped) bias; ``level`` is an integer tensor per device."""
    sign = p["sign"]
    id_pos, region = _ids_pos(p, level, vgs, vds, vbs)
    id_ = sign * id_pos  # stamped current (mosfet.go:354)

    vth = _vth(p, vbs)
    vgst = vgs - vth
    beta1 = p["kp"] * p["w"] / p["l"]

    # level 1 analytic conductances (mosfet.go:505-515)
    lin = region == LINEAR
    gm1 = torch.where(lin, beta1 * vds * (1.0 + p["lam"] * vds),
                      beta1 * vgst * (1.0 + p["lam"] * vds))
    gds1 = torch.where(
        lin,
        beta1 * (vgst - vds) * (1.0 + p["lam"] * vds)
        + beta1 * p["lam"] * (vgst * vds - 0.5 * vds * vds),
        0.5 * beta1 * vgst * vgst * p["lam"])

    # levels 2/3: numeric differencing (mosfet.go:517-532); the NMOS
    # perturbation is +delta and the PMOS one -delta in this frame
    d = DELTA * sign
    idg, _ = _ids_pos(p, level, vgs + d, vds, vbs)
    idd, _ = _ids_pos(p, level, vgs, vds + d, vbs)
    idb, _ = _ids_pos(p, level, vgs, vds, vbs + d)
    # the quotients as XLA computes them: x / 1e-6 -> x·1e6
    gm23 = torch.clamp_min((sign * idg - id_) * INV_DELTA, GMIN)
    gds23 = torch.clamp_min((sign * idd - id_) * INV_DELTA, GMIN)
    gmbs23 = torch.clamp_min((sign * idb - id_) * INV_DELTA, GMIN)

    use23 = (level == 2) | (level == 3)
    gm = torch.where(use23, gm23, gm1)
    gds = torch.where(use23, gds23, gds1)
    gmbs1 = torch.where(
        (p["gamma"] > 0) & (p["phi"] > 0) & (vbs < 0),
        gm * p["gamma"] / (2.0 * torch.sqrt(
            torch.clamp_min(p["phi"] - vbs, 1e-30))),
        GMIN)
    gmbs = torch.where(use23, gmbs23, gmbs1)

    cut = region == CUTOFF
    gm = torch.where(cut, GMIN, gm)
    gds = torch.where(cut, GMIN, gds)
    gmbs = torch.where(cut, GMIN, gmbs)
    # PMOS sign (mosfet.go:534-537): gm and gmbs flip, gds does not
    gm = gm * sign
    gmbs = gmbs * sign

    # Meyer capacitances (mosfet.go:540-594)
    cox = scalar_div(3.9 * EPS0, p["tox"])
    cgate = cox * p["w"] * p["l"]
    cgso = p["cgso"] * p["w"]
    cgdo = p["cgdo"] * p["w"]
    cgbo = p["cgbo"] * p["l"]
    cbs_eff = torch.where((p["cbs"] == 0) & (p["cj"] > 0),
                          p["cj"] * p["as"] + p["cjsw"] * p["ps"], p["cbs"])
    cbd_eff = torch.where((p["cbd"] == 0) & (p["cj"] > 0),
                          p["cj"] * p["ad"] + p["cjsw"] * p["pd"], p["cbd"])
    # 2·c/3 and c/3 as XLA computes them: products with the folded
    # constants
    half = true_div(cgate, 2.0)
    two_thirds = cgate * (2.0 / 3.0)
    cgs = torch.where(cut, cgso, torch.where(lin, half + cgso,
                                             two_thirds + cgso))
    cgd = torch.where(cut, cgdo, torch.where(lin, half + cgdo, cgdo))
    cgb = torch.where(cut, two_thirds,
                      torch.where(lin, cgbo, cgbo + cgate * (1.0 / 3.0)))
    return MosEval(id=id_, region=region, gm=gm, gds=gds, gmbs=gmbs,
                   cgs=cgs, cgd=cgd, cgb=cgb, cbs_eff=cbs_eff,
                   cbd_eff=cbd_eff)


def junction_charge(c_eff, v, p):
    """Charge of one bulk junction at voltage v (mosfet.go:597-637)."""
    cv = torch.where(
        v < 0,
        c_eff / pow_pos(torch.clamp_min(1.0 - v / p["pb"], 1e-30), p["mj"]),
        c_eff * (1.0 + p["mj"] * v / p["pb"]))
    return cv * v


def charges(p, ev: MosEval, vgs, vds, vbs):
    """Charge storage for the transient stamp (mosfet.go:597-637):
    (qgs, qgd, qgb, qbs, qbd)."""
    vgd = vgs - vds
    vbd = vbs - vds
    cut = ev.region == CUTOFF
    qgs = torch.where(cut, 0.0, ev.cgs * vgs)
    qgd = torch.where(cut, 0.0, ev.cgd * vgd)
    qgb = ev.cgb * (vgs - vbs)
    return (qgs, qgd, qgb, junction_charge(ev.cbs_eff, vbs, p),
            junction_charge(ev.cbd_eff, vbd, p))
