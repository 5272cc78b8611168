"""The graft entry points of the port (``__graft_entry__.py`` of the JAX
package).

``entry()`` gives a single-instance transient of the light RC deck as a
callable and its arguments; ``dryrun_multichip(n)`` builds an n-device
mesh, shards a Monte-Carlo batch of the same deck over it, runs the
sharded transient with its summed accepted-step count, the batch x
frequency AC mesh when n is even, and the sharded OP and DC sweep of a
diode deck, and reports which engine served each.  Both run on the card
unless given ``device="cpu"``; on the CPU a mesh of n CPU shards runs the
kernels' plain versions.

    python -m toyspice_tpu_torch.parallel.dryrun        # every card
"""

import numpy as np
import torch

# Light deck for the entry and the dryrun: RC only (no inductor), so LTE
# step control ramps dt up to tmax and the whole transient is ~60 accepted
# steps.
RLC_TINY = """* RC tiny
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

AC = """* rc ac
.ac DEC 4 10 100k
Vin 1 0 AC 1 0
R1 1 2 1k
C1 2 0 1u
"""

DIO = """* diode dc
.dc Vin 0 1 0.25
Vin 1 0 DC 0
D1 1 2 D
R1 2 0 1k
"""


def _config(cc):
    from ..engine.tran import build_config

    tp = cc.netlist.tran
    return build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)


def _spread(cc, kind, rng, b):
    """``kind``'s values spread log-normally by 0.05 over b lanes."""
    return {kind: {"value": np.asarray(cc.params[kind]["value"])[None, :]
                   * np.exp(rng.normal(0, 0.05, size=(b, 1)))}}


def entry(device="cuda"):
    """(fn, example_args): fn(params, state0) -> (accepted, state) runs the
    whole adaptive transient of one instance of RLC_TINY (a batch of one
    through ``make_tran_batch``: the whole-run kernel on the card)."""
    from ..compiler import compile_circuit
    from ..engine.batch import batch_params, make_tran_batch
    from ..engine.state import init_state
    from ..netlist.parser import parse

    cc = compile_circuit(parse(RLC_TINY))
    params, axes = batch_params(cc, {}, device=device)
    tran = make_tran_batch(cc, _config(cc), axes, store="none")

    def fn(params, state0):
        out = tran(params, state0)
        return out.accepted[0], {kind: {key: leaf[0]
                                        for key, leaf in tbl.items()}
                                 for kind, tbl in out.state.items()}

    return fn, (params, init_state(cc, device=device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded analyses on an ``n_devices`` mesh, with the same
    assertions and report as the JAX package's ``dryrun_multichip``."""
    from ..compiler import compile_circuit
    from ..engine.ac import frequency_points
    from ..engine.batch import batch_params
    from ..netlist.parser import parse
    from .mesh import (make_mesh, make_mesh_2d, run_ac_sharded,
                       run_dc_sharded, run_op_sharded,
                       run_transient_sharded)

    cc = compile_circuit(parse(RLC_TINY))
    mesh = make_mesh(n_devices, device=device)
    home = mesh.first()
    batch = n_devices * 2
    rng = np.random.default_rng(0)
    params, axes = batch_params(cc, _spread(cc, "R", rng, batch),
                                device=home)

    out, total = run_transient_sharded(cc, _config(cc), mesh, params, axes)
    total = int(total)
    fails = int(out.fail.sum())
    if total <= 0:
        raise RuntimeError("sharded transient accepted no steps")
    if fails:
        raise RuntimeError(f"{fails} instances failed")
    tran_engine = (f"tran engine={run_transient_sharded.last_engine} "
                   f"({run_transient_sharded.last_reason})")

    # 2-D mesh: Monte-Carlo batch x frequency sweep
    ac_info = ""
    if n_devices >= 2 and n_devices % 2 == 0:
        cca = compile_circuit(parse(AC))
        mesh2 = make_mesh_2d((n_devices // 2, 2), device=device)
        bsz = (n_devices // 2) * 2
        pa, axa = batch_params(cca, _spread(cca, "C", rng, bsz),
                               device=home)
        freqs = frequency_points("DEC", 10.0, 100e3, 16)
        xr, xi, opr = run_ac_sharded(cca, mesh2, pa, axa, freqs)
        if not (bool(torch.hypot(xr, xi).isfinite().all())
                and bool(opr.converged.all())):
            raise RuntimeError("sharded AC: a value not finite or a bias "
                               "not converged")
        ac_info = (f"; 2-D mesh {n_devices // 2}x2 AC batch {bsz} x "
                   f"{len(freqs)} freqs OK")

    # sharded OP and DC sweep: a diode deck exercises real per-shard Newton
    ccd = compile_circuit(parse(DIO))
    pd_, axd = batch_params(ccd, _spread(ccd, "R", rng, batch), device=home)
    opr = run_op_sharded(ccd, mesh, pd_, axd)
    if not bool(opr.converged.all()):
        raise RuntimeError("sharded OP failed")
    pts = np.linspace(0.0, 1.0, 5)
    xs, conv = run_dc_sharded(ccd, (0,), mesh, pd_, axd, pts)
    if not (bool(conv.all()) and bool(xs.isfinite().all())):
        raise RuntimeError("sharded DC sweep failed")

    print(
        f"dryrun_multichip OK: {n_devices} devices, batch {batch}, "
        f"aggregate accepted steps {total}{ac_info}; "
        f"sharded OP + DC sweep ({len(pts)} pts) OK\n"
        f"  {tran_engine}\n"
        f"  op engine={run_op_sharded.last_engine} "
        f"({run_op_sharded.last_reason})\n"
        f"  dc engine={run_dc_sharded.last_engine} "
        f"({run_dc_sharded.last_reason})"
    )


if __name__ == "__main__":
    fn, args = entry()
    accepted, _ = fn(*args)
    print("entry OK, accepted steps:", int(accepted))
    dryrun_multichip(torch.cuda.device_count())
