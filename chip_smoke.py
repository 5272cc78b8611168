#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``toyspice_tpu_torch``.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It needs PyTorch built for CUDA and ``nvcc`` (the CUDA toolkit), and imports
neither JAX nor the JAX package.  Phases, each on its own line with its
seconds:

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: the whole-run kernel (its compat instantiations in
   run_kernel.cu, its physics ones in run_kernel_phys.cu, its physics
   magnetic and compat magnetic Newton ones in run_kernel_mag.cu, each
   source built without and with the waveform store, each of those as two
   objects, the 64-row and block buckets and the rest), the OP kernel, the
   DC sweep kernel, the stamped solve (a warp segment per lane to np1 =
   32, a warp per lane to 64, a block per lane above: in registers to 144,
   in shared memory to 168, past it in device memory), the AC kernel (a
   warp segment per system to 2N = 64, past it a block per system on the
   GJ kernel's bodies: registers to 144, shared memory to 168, device
   memory above) and the GJ kernel, one ``nvcc`` call per library or part, all started
   together (ops/_build.py) in a thread of their own, while phase 3's
   and phase 27's plain versions, which need no library, run on the
   card; the line gives each library's seconds.
3. run kernel against its plain torch version on linear decks, on the
   card (the plain versions first, beside the build): 256 lanes each of an RC driven by SIN, an RL driven by PULSE and a
   PWL current source into an RC ladder, the RL deck again with minstep =
   NaN on 64 lanes, and the 8192 lanes of bench.py's RLC deck (perturbed as
   bench.py does).  accepted/attempts/fail/nr_iters must be equal per lane,
   state, t_final and dt_final bit for bit (and within rtol 1e-9).
4. linear main path: parse -> compile_circuit -> batch_params -> init_state
   -> build_config -> make_tran_batch(store="none") on those 8192 lanes,
   one warm-up run and one timed run; the launch counts are reset just
   before the timed run.  Every lane must finish without failing, through
   the kernel, with the same result as phase 3's kernel run.
5. OP kernel against its plain version through ``make_op_fused`` (rescue
   ladders included): ce_amplifier_op.cir, the diode divider, the MOSFET
   bias deck and the half-wave rectifier's bias, 8192 lanes with R spread
   log-normally by 0.1; the diode stack HARD_V with V1 drawn per lane in
   [2, 100] V (stages 0 and 2 both occur) and the current-driven HARD_I
   (no lane converges), 256 lanes.  converged, stage and the iteration
   counts must be equal per lane, x and jv bit for bit.
6. run kernel against its plain version on nonlinear decks:
   half_wave_rectifier.cir, nmos_inverter_tran.cir and a CE-amplifier BJT
   transient, 8192 lanes, R and C spread log-normally by 0.1, warm-started
   from their OP; the same bar as phase 3, jv included.
7. nonlinear main path: make_tran_batch on the half-wave rectifier, 8192
   lanes, the full 2 ms: engine "run", the OP kernel and the run kernel
   each launched, no lane failed, the lanes equal to phase 6's kernel run.
8. linear OP and linear DC sweep: run_op_batch on divider_op.cir and
   run_dc_batch on the linear divider sweep, 8192 lanes, R spread 0.1, each
   one launch of the stamped-solve kernel; then the stamped-solve kernel
   against its plain version under the same entries (converged and stage
   equal, x within rtol 1e-9), and torch.linalg.solve on the same systems.
9. DC sweep: run_dc_batch on diode_iv_sweep.cir, 8192 lanes, Rsen and the
   diode's Is spread 0.1, all 35 points in one launch of the DC sweep
   kernel; then the kernel against its plain version (conv and iterations
   equal per point, xs bit for bit).
10. AC: run_ac_batch on ce_amplifier_ac.cir, 8192 lanes, R and C spread
   0.1, 12 frequencies: the OP kernel's bias, then one launch of the AC
   kernel for the 98,304 (instance, frequency) systems; then the AC kernel
   against its plain version on the same G, B^ and RHS (bit-identical),
   and torch.linalg.solve on the same systems.
11. run kernel against its plain version on the magnetic decks:
   coupled_inductors.cir (K between two L) and saturating_transformer.cir
   (two LM windings and their K), 256 lanes, R (and L) spread; the bar of
   phase 3.
12. magnetic main path: make_tran_batch on saturating_transformer.cir,
   8192 lanes (BENCH_MATRIX's transformer3 class), one run-kernel launch,
   no lane failed, the lanes equal to a kernel run on the same inputs;
   then that kernel run against its plain version (the bar of phase 3).
13. the store instantiation against its plain version, ``store='full'``:
   the RC driven by SIN, half_wave_rectifier.cir and coupled_inductors.cir
   (its lanes stopped at 2000 attempts: phase 11 runs it to tstop),
   256 lanes:
   out_n equal per lane, out_x/out_t bit for bit, and the counters
   and state equal to the run kernel on the same lanes.  Then
   64-bit offsets: 8192 lanes of an RC ladder with np1 = 11, whose out_x
   passes element 2^31; the lanes from just below that element to the
   last one against the plain version run on those lanes.
14. store main path: make_tran_batch(store='full') on the half-wave
   rectifier, 8192 lanes: one OP and one store launch, counters equal to
   phase 7's store='none' run; then the store kernel against its plain
   version on the same 8192 lanes.  The store kernel is timed around its
   wrapper (which zeroes the output) and around the launch alone, into
   zeroed buffers given as ``out``.
15. streamed main path: stream_transient_chunks on the 8192 lanes of
   phase 4 with chunk_store = 4096 (BENCH_MATRIX's full-streamed row),
   every chunk equal bit for bit to the matching rows of one monolithic
   store launch, which is held to its plain version on the same lanes;
   the totals equal to phase 4's; run_transient_streamed's host stitch
   at 256 lanes equal to its monolithic run.
16. resume: bench.py's deck, 256 lanes, a run cut at half its attempts,
   then a resume from its state, t, dt and attempt count, equal to the
   one-piece run.
18. physics: the PHYS run kernel and its store instantiation against their
   plain versions, 256 lanes, R and C spread, from the physics OP's bias
   point: the rectifier under BE and trap, sine-driven Rs and Bv diodes
   (trap), the NMOS inverter (trap, cut to 0.2 ms and 120 attempts),
   the BJT transient
   (BE) and rlc_ringdown.cir (trap, its linear OP first, the lanes
   stopped at 1000 attempts);
   counters and out_n equal, state, jv and waveforms bit for bit,
   the store's counters and state equal to the run kernel's.
19. the OP kernel's physics flavour against its plain version through
   make_op_fused: the Rs and Bv diodes, ce_amplifier_op.cir and the
   rectifier's bias, 8192 lanes (the bar of phase 5).
20. physics DC sweep: run_dc_batch(semantics="physics") on
   diode_iv_sweep.cir with the diode's Rs drawn per lane, one launch of
   the DC sweep kernel's physics flavour, then the kernel against its
   plain version (the bar of phase 9).
21. physics main path, half_wave_rectifier_8192_physics_trap:
   make_tran_batch(semantics="physics", SimOptions(integration="trap"))
   on the 8192 lanes of phase 7: one OP launch, the bias-point seed, one
   run-kernel launch, no lane failed; then the kernel on the same inputs
   against its plain version.
22. physics magnetics: the PHYS MAG run kernel against its plain version,
   256 lanes, R spread, from the linear OP's bias point:
   saturating_transformer.cir under BE and trap, coupled_inductors.cir
   under trap (its lanes stopped at 2000 attempts), TRANS_SMALL and
   XFMR_MAG under BE (fail parity: the counters include fail); then the
   store path make_tran_batch(store='full') on the saturating
   transformer under trap (one stamped solve, one store launch) and the
   physics MAG store instantiation against the plain store.
23. LM and K with a diode (TRANS_SMALL with a rectifier on its secondary,
   256 lanes) under compat and physics/trap: the transient path (the OP
   kernel with the windings' branch diagonal, then the MAG Newton
   instantiation) and the kernel against its plain version; the OP path
   (run_op_batch) and the DC sweep path (run_dc_batch, 15 points), each
   kernel against its plain version.
24. magnetic AC: run_ac_batch on saturating_transformer.cir with an AC
   source, 8192 lanes, 9 frequencies: one stamped solve, one AC launch;
   the AC kernel against its plain version.
25. physics magnetic main path, saturating_transformer_8192_physics_trap:
   make_tran_batch(semantics="physics", SimOptions(integration="trap"))
   on the 8192 lanes of phase 12: one stamped-solve launch (the linear
   OP), the bias-point seed, one launch of the PHYS MAG run kernel, no
   lane failed, every lane at tstop; then the linear OP's stamped solve
   and the run kernel on the same inputs against their plain versions.
26. physics store main path: make_tran_batch(semantics="physics",
   store='full') on phase 21's 8192 lanes (one OP launch, one PHYS store
   launch, 9.8 GB of output), then that store kernel against the plain
   store on the same lanes, timed alone and through its wrapper.
27. the GJ kernel (csrc/gj_kernel.cu) against gj_plain on 259 random
   systems each of n = 1, 2, 4, 5, 6, 8, 9, 16, 17, 32, 33, 40, 48, 49,
   64, 65, 72, 73, 96, 97, 127, 128, 129, 130, 144, 145, 168, 169 and 200
   (its bucket edges and the stamped solve's: a row a thread to 96, the
   registers of a 512-thread block to 144, shared memory to NBIG = 168,
   device memory above), with a zero diagonal, a singular lane, a NaN
   lane, a late NaN and a tie between rows on different warps: the same
   non-finite lanes and the same bits, and on the same systems the
   stamped solve (a warp segment a system to 32, a warp to 64, a block
   above) and its plain version; then the GJ kernel beside
   torch.linalg.solve on 8192 random systems of 128 and of 132.
28. the general engine against the run kernel on an eligible deck: the
   half-wave rectifier, 256 lanes, through engine/tran.make_tran (the
   general OP with its GJ seed, the general Newton over the stamped solve)
   and through make_tran_batch (the OP and run kernels): counters equal,
   state and jv within rtol 1e-9.
29. the main path cw16_8192: a 16-stage Cockcroft-Walton multiplier
   (np1 = 35, 32 diodes: the 64-row bucket, a warp a lane), C spread 0.1,
   make_tran_batch to 2 ms: engine "run", one OP and one run launch, no
   stamped or GJ launch, no lane failed, every lane at tstop, every
   capacitor voltage finite and under 3200 V; the run kernel against its
   plain version bit for bit on those lanes over the first 0.1 ms and on
   259 lanes over the whole run, the OP kernel against its plain
   version; then, under TOYSPICE_TRAN=general, the general engine over
   the first 0.1 ms (one GJ launch for the OP's seed, a stamped launch of
   the warp instantiation per batched Newton iteration): counters equal
   to the run kernel's over that cut, state within rtol 1e-9, and its
   kernels against their plain versions (bit-identical).
30. lc16_ac_8192: a 16-section LC ladder (np1 = 36, a 72 x 72 AC system),
   C spread 0.1, run_ac_batch: the linear OP (one stamped launch at
   n = 36), then one AC launch for the 8192 x 21 = 172,032 systems (a
   block a system, a row a thread), no GJ launch; the AC kernel against
   ac_plain on them, bit for bit on every system, torch.linalg.solve as
   the yardstick; then under TOYSPICE_AC=general the general branch (one
   stamped and one GJ launch), its x within rtol 2e-9 of the AC kernel's,
   the GJ kernel against gj_plain on its dense systems, bit for bit.
31. compat semantics under integration="trap" in the analyses, served as
   backward Euler as the JAX package serves them: run_op_batch and
   run_dc_batch on the half-wave rectifier and run_ac_batch on it with an
   AC source, 1024 lanes: the OP, DC sweep and AC kernels launched, each
   result equal bit for bit to compat/BE's and each kernel bit-identical
   to its plain version; make_tran_batch still refuses compat/trap.
32. decks past n = 128: a 127-stage RC ladder (np1 = 130), C spread 0.1,
   1024 lanes, make_tran_batch to 0.05 ms: engine "run" (one launch of
   the run kernel's block bucket), then under TOYSPICE_TRAN=general the
   general engine, whose systems a block holds in its registers
   (csrc/gj_block.cuh gj_wide): one launch of the stamped solve's wide
   body per batched Newton iteration and no other kernel, no lane failed,
   every lane at tstop, counters equal to the run engine's; then
   run_ac_batch on a 31-section LC ladder (np1 = 66, systems of 132),
   lc31_ac_8192: 8192 lanes x 21 frequencies, one stamped launch (the
   linear OP) and one AC launch through the wide register body, no GJ
   launch, the AC kernel against ac_plain bit for bit on every system; and
   at 1024 lanes under TOYSPICE_AC=general: one stamped launch, one GJ
   launch through the wide body, torch.linalg.solve as the yardstick.  Each names the body that ran (ops/solve.py body).  For both,
   the kernels against their plain versions on the same lanes: counters
   equal, bit for bit.
33. the user surface: ``run_analysis`` on the card, one instance of each
   of divider_op, ce_amplifier_op, diode_iv_sweep, ce_amplifier_ac,
   rc_lowpass_tran and half_wave_rectifier (the general engine at B = 1:
   a stamped launch per Newton iteration, the GJ kernel for a nonlinear
   OP's seed and the AC systems), timed deck by deck with nothing else
   on the card; each deck's Results within the host engine's bars and
   bit for bit those of the same call under TOYSPICE_SOLVER=xla (the
   plain versions, no launch), whose B = 1 systems are kept; beside that
   pass, ``python -m toyspice_tpu_torch circuits/half_wave_rectifier.cir``
   in a process of its own exits 0 with the tables of the in-process run,
   and ``cli.main`` with ``--engine host`` and ``host-native`` exits 0
   (the native library built by ``make -C native`` in a thread); then,
   with nothing else on the card, the kept systems are replayed and timed
   on the kernels, the plain versions and torch.linalg.solve (bit for
   bit).  The script refuses to run while a TOYSPICE_* engine override
   is set.
34. the sharded mesh (``toyspice_tpu_torch/parallel/mesh.py``): phase 4's
   8192 lanes through run_transient_sharded on make_mesh(1) and on a
   mesh of four shards of cuda:0 (one run-kernel launch a shard), bit for
   bit with phase 4 and the summed count equal to its accepted steps
   (across several cards too where the machine has them); then, each held
   bit for bit to its unsharded run with the launches counted: the
   rectifier's OP and diode_iv_sweep's sweep at 8192 lanes on four shards
   (the OP and DC sweep kernels), ce_amplifier_ac on a (2, 2) mesh (the
   OP and AC kernels) and lc16_ac_8192 on a (2, 3) mesh (its 21
   frequencies: the stamped and AC kernels), the rectifier with
   store='full', and rc127 at 1024 lanes on four shards on the run
   engine (the block bucket) and under TOYSPICE_TRAN=general;
   then dryrun_multichip on every card.  Each wall is printed beside the
   unsharded one.
35. the 64-row bucket's other instantiations at 259 lanes, each through
   its entry point (counts reset before) and then bit for bit against its
   plain version: compat linear at np1 = 64 (a 61-stage RC ladder), cw16
   under physics BE and trap to 0.1 ms, TRANS_SMALL's secondary into a
   28-section RC ladder (np1 = 35; compat and physics/trap) and with a
   diode at its end (np1 = 36, the magnetic Newton ones), a deck of np1 =
   4 with 30 MOSFETs (whose value slots overflow its bucket's block, so
   it takes the 64-row bucket), cw16 with store='full' to 0.1 ms and its
   streamed stitch, cw16's OP under physics, and the DC sweep of a string
   of 32 diodes (compat at 8192 lanes, physics at 259).
36. the block bucket (np1 past 64: a lane on a whole block of 256
   threads, its system built and eliminated by gj_block in the block's
   slice, shared memory while it fits, else a slice of a device-memory
   workspace): the main paths rc127_8192 (np1 = 130, to 0.05 ms: one run
   launch, no stamped or GJ launch; beside phase 32's two engines at 1024
   lanes), cw32_8192 (a 32-stage Cockcroft-Walton multiplier, np1 = 67,
   64 diodes, to 2 ms: one OP launch, then one run launch) and the DC
   sweep of a string of 64 diodes at 8192 lanes x 9 points (one launch),
   each with its run launch alone and its kernel bit for bit against its
   plain version on 259 of its lanes; then at 259 lanes, through the
   entry points and bit for bit against the plain versions: compat linear
   at np1 = 65, cw32 under physics BE and trap to 0.1 ms, TRANS_SMALL's
   secondary into a 60-section RC ladder (np1 = 67; compat and
   physics/trap) and with a diode at its end (the magnetic Newton ones),
   a 180-stage ladder (np1 = 183) on the device-memory workspace, rc127
   with store='full' and its stream in 3 chunks, cw32's OP under physics
   and the diode string's sweep under physics.
37. the AC kernel's buckets at 259 instances x 3 frequencies, each
   through run_ac_batch (counts reset before: one stamped or OP-kernel
   bias, one AC launch) and then bit for bit against ac_plain: LC ladders
   at each bucket edge (np1 = 32, the warp body; 34 and 48, a row a
   thread; 50 and 72, the registers of 16 warps; 74 and 84, shared
   memory; 86 and 104, the device-memory workspace), an RC ladder at np1 =
   33 and 29 diodes in series (np1 = 34, the OP kernel's bias) under
   compat and physics.
38. the run, store, OP and DC sweep kernels past their former caps (more
   than 32 sources, a stamp plan past the 48 KB table; the table read in
   device memory where it does not fit shared memory beside the lanes'
   slices): the main paths nmos_ring101_8192 (a 101-stage NMOS ring
   oscillator, np1 = 104, UIC: one run launch), bus48_8192 (48 coupled
   PULSE-driven lines, np1 = 145, 48 sources: one run launch) and
   pv72_iv_8192 (a 72-cell PV module with 3 bypass diodes, 73 sources:
   its OP, then a 121-point I-V sweep in one launch), each against the
   general engine at 259 lanes over a short span and its kernels bit for
   bit against their plain versions, and the PV module's AC through the
   OP kernel's bias; the ring's one lane whose node ends off the rails
   and the module's one point that does not converge are those the CPU
   tests hold to the JAX package, and no other; then at 259 lanes,
   through the entry points and bit for bit against the plain versions
   over a few attempts: more than 32 sources in every bucket (under
   physics and with K too), the table in device memory in the 64-row and
   block buckets, where alone the placement puts it (the block with its
   slice in shared memory and in the workspace), the store's 3-chunk
   stream on the bus and the NMOS ring, and the OP and DC sweep with the
   table in device memory.
17. the bounds and the ``kernels`` JSON line; the last line is the contract
   line ``{"ok": true, "device": {...}}``.

Each main path (phases 4, 7, 8, 9, 10, 12, 14, 15, 16, 20, 21, 25, 26,
29, 30, 32, 33, 34, 36, 38) and each path of phases 22-24, 28, 31, 35-38
runs with every kernel's launch count set to 0 just before and read just
after.
"""

import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import toyspice_tpu_torch as ts  # noqa: E402
from toyspice_tpu_torch import native  # noqa: E402
from toyspice_tpu_torch.compiler import SRC_PULSE, SRC_PWL, SRC_SIN  # noqa: E402
from toyspice_tpu_torch.engine.ac import make_ac, make_ac_batch  # noqa: E402
from toyspice_tpu_torch.engine.dc import make_dc  # noqa: E402
from toyspice_tpu_torch.engine.op import make_op  # noqa: E402
from toyspice_tpu_torch.engine.options import DEFAULTS  # noqa: E402
from toyspice_tpu_torch.engine.overrides import VARS as OVERRIDES  # noqa: E402
from toyspice_tpu_torch.engine.tran import make_tran  # noqa: E402
from toyspice_tpu_torch.ops import (_build, ac, dc, op, run,  # noqa: E402
                                    run_plan, solve, solve_stamped)
from toyspice_tpu_torch.parallel import dryrun, mesh  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_LANES = 8192
SMALL_LANES = 256
NAN_LANES = 64
RESCUE_LANES = 256
RTOL = 1e-9  # both sides f64; they may differ only in rounding order
DEVICE = "cuda"
# H100 SXM f64 rate outside the tensor cores (NVIDIA data sheet) and HBM3
# bandwidth, for the bounds of the kernels
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""

RC_SIN = """* rc sin
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

RL_PULSE = """* rl pulse
.tran 0.02m 1m
Vin 1 0 PULSE(0 5 0.1m 0.01m 0.01m 0.3m 0.8m)
R1 1 2 50
L1 2 0 10m
"""

IPWL = """* isrc pwl into rc ladder
.tran 0.02m 1m
I1 0 1 PWL(0 0 0.2m 3m 0.5m 1m)
R1 1 0 1k
C1 1 0 0.2u
C2 1 2 0.1u
R2 2 0 2k
"""

# an RC ladder of eight sections: np1 = 11, so 8192 lanes of max_store
# rows pass element 2^31 of the store
LADDER = """* rc ladder
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 0.1u
R2 2 3 100
C2 3 0 0.1u
R3 3 4 100
C3 4 0 0.1u
R4 4 5 100
C4 5 0 0.1u
R5 5 6 100
C5 6 0 0.1u
R6 6 7 100
C6 7 0 0.1u
R7 7 8 100
C7 8 0 0.1u
R8 8 9 100
C8 9 0 0.1u
"""

# an RC ladder of np1 = 32: a lane's committed state, device rows and
# source records (219 doubles) pass the 192 that the linear run kernel
# stages in shared memory (csrc/run_kernel.cuh SEG_ROWS), so its segments,
# each a whole warp, read them in device memory
LADDER32 = ("* rc ladder, np1 = 32\n.tran 0.02m 0.2m\nVin 1 0 SIN(0 5 1k)\n"
            + "".join(f"R{i} {i} {i + 1} {100 + i}\nC{i} {i + 1} 0 0.1u\n"
                      for i in range(1, 30))
            + "R30 30 0 1k\n")

# ce_amplifier_ac.cir's circuit with a SIN drive
BJT_TRAN = """* CE amplifier transient (ce_amplifier_ac.cir's circuit, SIN drive)
.tran 5u 2m
Vcc vcc 0 DC 12
Vsig sig 0 SIN(0 20m 1k)
Rsrc sig in 600
Cin in base 10u
Rb1 vcc base 68k
Rb2 base 0 12k
Rc vcc col 3.3k
Re emit 0 680
Cb emit 0 47u
Q1 col base emit QNPN
.model QNPN NPN (Bf=180 Vaf=90)
"""

# tests/test_fused_op.py's bias decks
D_DIV = """* diode divider
.op
Vin 1 0 DC 2
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 N=1.2)
"""

M_BIAS = """* MOSFET bias
.op
VDD 1 0 DC 5
VG 2 0 DC 2
RD 1 3 10k
M1 3 2 0 0 NM L=2u W=20u
.model NM NMOS(Level=1 VTO=0.7 KP=20u LAMBDA=0.01)
"""

# tests/test_rescue.py's diode stacks: only source stepping rescues HARD_V;
# nothing rescues HARD_I (source stepping scales V sources only)
HARD_V = """diode stack
.op
V1 1 0 DC 100
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-15 N=1.0)
"""

HARD_I = """i-driven stack
.op
I1 0 1 DC 1
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-18 N=0.7)
"""


# tests/test_analytic_ac_dc.py's linear sweep
DIVIDER_DC = """divider sweep
.dc Vin 0 10 0.5
Vin in 0 DC 0
R1 in mid 3k
R2 mid 0 1k
"""

# tests/test_physics_mode.py's Rs and Bv diodes (physics semantics cashes
# both; compat ignores them)
D_RS = """* forward diode with series resistance
.tran 0.05m 0.5m
Vin 1 0 DC 5
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Rs=100)
"""

D_BV = """* reverse diode into breakdown
.tran 0.05m 0.5m
Vin 1 0 DC -200
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Bv=100)
"""

# the same diodes driven by a sine into a capacitor, with a transit time:
# the Rs inner Newton and the breakdown region over a transient
D_RS_SIN = """* Rs diode, sine drive
.tran 0.05m 0.5m
Vin 1 0 SIN(0 5 5k)
R1 1 2 1k
D1 2 0 DM
C1 2 0 10n
.model DM D (Is=1e-14 Rs=100 Tt=10n)
"""

D_BV_SIN = """* Bv diode, sine drive through breakdown
.tran 0.05m 0.5m
Vin 1 0 SIN(-150 60 5k)
R1 1 2 1k
D1 2 0 DM
C1 2 0 10n
.model DM D (Is=1e-14 Bv=100 Tt=10n)
"""

# tests/test_fused_tran.py's small two-winding J-A transformer (where the
# JAX run kernel misses the general engine under physics/be) and
# transformer3's topology
TRANS_SMALL = """* small 2-winding J-A transformer
Vin 1 0 sin(0 10 1k)
Rp 1 2 0.5
Lp 2 0 core=C1 turns=300
Ls 3 0 core=C1 turns=150
Rload 3 0 1000
.model C1 core(ms=1.6e6 alpha=1e-3 a=1000 c=0.1 k=2000 area=1e-4 len=0.1)
K1 Lp Ls 0.95
.tran 20u 1m
"""

XFMR_MAG = """* J-A core transformer (transformer3.cir topology)
.tran 0.05m 1m
Vin 1 0 SIN(0 10 1k)
Rp 1 2 0.1
Lp 2 0 core=C1 turns=300
Rs 3 4 0.1
Ls 3 0 core=C1 turns=150
Rload 4 0 1000
.model C1 core(ms=1.6e6 alpha=1e-3 a=1000 c=0.1 k=2000 area=1e-4 len=0.1)
K1 Lp Ls 0.95
"""

# TRANS_SMALL with a half-wave rectifier on its secondary: LM and K with a
# diode
LM_DIODE = TRANS_SMALL.replace(
    "Rload 3 0 1000", "D1 3 4 DMOD\nRload 4 0 1k\nCload 4 0 10u\n"
    ".model DMOD D(IS=1e-14)")

# every kernel wrapper's launch count
COUNTERS = {"run_kernel": run.launch_run_kernel,
            "run_kernel_store": run.launch_store_kernel,
            "op_kernel": op.launch_op_kernel,
            "stamped_solve": solve_stamped.launch_stamped,
            "dc_sweep_kernel": dc.launch_dc_kernel,
            "ac_kernel": ac.launch_ac_kernel,
            "gj_kernel": solve.launch_gj}


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def check_counts(what, got, want):
    """Each kernel's launches within its (lo, hi) of ``want``; every kernel
    not named there must have none."""
    for name, n in got.items():
        lo, hi = want.get(name, (0, 0))
        if not lo <= n <= hi:
            fail(f"{what}: {name} launched {n} times, expected "
                 f"{lo}..{hi}")


def deck_file(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


def phase(name, t0, text):
    print(f"[{name}] {text} ({time.perf_counter() - t0:.3f} s)", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def perturbed(cc, rng, b, keys, spread=0.1):
    """bench.py's log-normal perturbation of each kind's "value" leaf."""
    return {k: {"value": np.asarray(cc.params[k]["value"])[None, :] * np.exp(
        rng.normal(0.0, spread, size=(b, len(cc.params[k]["value"]))))}
        for k in keys if k in cc.params}


def rc_spread(cc, b):
    """R then C, spread 0.1, numpy default_rng(0)."""
    return perturbed(cc, np.random.default_rng(0), b, ("R", "C"))


def setup(deck, overrides_fn, b):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = (ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
           if tp is not None and tp.tstop > 0 else None)  # None: an .op
    params, axes = ts.batch_params(cc, overrides_fn(cc, b))
    return cc, cfg, params, axes, ts.init_state(cc)


def lane_inputs(cc, cfg, params, state0, opts=DEFAULTS,
                semantics="compat"):
    """The run kernel's (plan, dev, src, state, scalars, jv) for one deck,
    as make_tran_run builds them (ops/run.run_inputs): unless UIC, the OP
    of a nonlinear or physics deck first, then its junction voltages (and
    under physics the state seeded from the bias point)."""
    r = run.run_inputs(cc, cfg, params, state0, opts, semantics)
    return r.plan, r.dev, r.src, r.st, r.sc, r.jv


def ptxas_summary(log):
    """Registers, stack frame and spills of each kernel instantiation, from
    ``nvcc -Xptxas -v`` output."""
    out, entry, label, frame, mine = [], None, None, None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, frame = m.group(1), None
            k = re.search(r"(run_seg_kernel|op_seg_kernel|"
                          r"stamped_seg_kernel|dc_seg_kernel|ac_kernel)"
                          r"ILi(\d+)E((?:Lb[01]E)*)", entry)
            # the block bucket's kernels: run_block_kernel<NL, MAG, STORE,
            # PHYS, TSH>, op_block_kernel<PHYS, TSH>, dc_block_kernel<PHYS,
            # TSH> (TSH false: the table read in device memory)
            blk = re.search(r"(run_block_kernel|op_block_kernel|"
                            r"dc_block_kernel)I((?:Lb[01]E)+)", entry)
            if blk is not None:
                bits = re.findall(r"Lb([01])E", blk.group(2))
                bnames = ([("linear", "newton"), ("", "mag"), ("", "store"),
                           ("", "physics")]
                          if blk.group(1) == "run_block_kernel"
                          else [("compat", "physics")]) + [
                              ("device table", "")]
                label = blk.group(1) + "<" + ", ".join(
                    n_[int(f)] for n_, f in zip(bnames, bits) if n_[int(f)]
                ) + ">"
                continue
            flags = [] if k is None else re.findall(r"Lb([01])E",
                                                    k.group(3))
            # run_seg_kernel<NMAX, NL, MAG, STORE, PHYS, TSH> (NL: a Newton
            # deck; TSH false: the table read in device memory),
            # op_seg_kernel<NMAX, PHYS, TSH> and dc_seg_kernel<NMAX, PHYS,
            # TSH>; the other kernels' flags are not named
            kname = k.group(1) if k is not None else None
            names = ([("linear", "newton"), ("", "mag"), ("", "store"),
                      ("", "physics"), ("device table", "")]
                     if kname == "run_seg_kernel" else
                     [("", "physics"), ("device table", "")]
                     if kname in ("op_seg_kernel", "dc_seg_kernel") else
                     [("", "physics")])
            # the warp kernels' REG flag, the block kernels' NMAX (0: the
            # shared-memory body); the name follows its mangled length,
            # which tells gj_kernel from the source's gj_kernel_cu
            g = re.search(r"(?<=\d)(gj_kernel|stamped_block_kernel|"
                          r"ac_smem_kernel|stamped_warp_kernel|"
                          r"gj_work_kernel|stamped_work_kernel|"
                          r"ac_rows_kernel|ac_wide_kernel|ac_block_kernel)"
                          r"(?:ILb([01])E|ILi(\d+)E)?", entry)
            where = ""
            if g is not None and g.group(2):
                where = "<registers>" if g.group(2) == "1" else "<shared>"
            elif g is not None and g.group(3):
                where = ("<shared>" if g.group(3) == "0"
                         else f"<{g.group(3)}, registers>")
            label = (g.group(1) + where if g else entry) if k is None else (
                f"{k.group(1)}<{k.group(2)}" + "".join(
                    f", {names[i][int(f)]}" for i, f in enumerate(flags)
                    if i < len(names) and names[i][int(f)]) + ">")
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mine = m.group(1) == entry
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and mine:
            frame, mine = m.groups(), False
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            f = frame or ("?", "?", "?")
            out.append(f"{label} {m.group(1)} registers, {f[0]} B stack "
                       f"frame, {f[1]}/{f[2]} B spill stores/loads")
            entry = None
    return out


# ------------------------------------------------------------- the bounds
# The fewest f64 operations the work needs, a transcendental as one: the
# device evaluations and stamps as the kernels do them, each linear system
# as a dense LU solve (fewer operations than the kernels' Gauss-Jordan).


def lu_flops(n):
    """Gaussian elimination of an n x n real system with one right-hand
    side: per pivot k one division and n - k multiply-subtracts in each of
    the n - 1 - k rows below it, then back substitution (a multiply-subtract
    per known unknown and one division per row)."""
    fwd = sum((n - 1 - k) * (1 + 2 * (n - k)) for k in range(n))
    return fwd + sum(2 * (n - 1 - i) + 1 for i in range(n))


def complex_lu_flops(n):
    """The same for an n x n complex system, in real operations: a complex
    multiply-subtract is 8, a complex multiply 6 and each pivot's
    reciprocal 5."""
    fwd = sum((n - 1 - k) * (6 + 8 * (n - k)) for k in range(n))
    return fwd + sum(8 * (n - 1 - i) + 6 for i in range(n)) + 5 * n


def build_flops(plan, entries):
    """One add per stamp, plus its division or product by dt."""
    per_tag = {run_plan.TAG_G: 0, run_plan.TAG_GEQ: 1, run_plan.TAG_LTERM: 1,
               run_plan.TAG_ONE: 0, run_plan.TAG_CEQ: 1,
               run_plan.TAG_LRHS: 2, run_plan.TAG_VSRC: 0,
               run_plan.TAG_ISRC: 0, run_plan.TAG_NL: 0,
               run_plan.TAG_LMTERM: 1, run_plan.TAG_LMRHS: 2,
               run_plan.TAG_KTERM: 1, run_plan.TAG_KRHSA: 2,
               run_plan.TAG_KRHSB: 2}
    return sum(1 + per_tag[int(tag)] for tag in entries[:, 2])


def step_flops(plan):
    """An attempt's work around its solve: sources, LTE, step control and
    the commit of an accepted step."""
    nc, nl = plan.counts[1:3]
    src = 0
    for kind in plan.stype:
        for s in plan.stype[kind]:
            src += {SRC_SIN: 8, SRC_PULSE: 16,
                    SRC_PWL: 3 * plan.knots[kind] + 6}.get(int(s), 0)
    return src + 6 * nc + 10 * nl + 3 * nc + 8 * nl + 10


def attempt_flops(plan):
    """A linear deck's attempt: step work plus one build and solve."""
    return step_flops(plan) + build_flops(plan, plan.entries) + lu_flops(
        plan.np1)


def newton_flops(plan):
    """One Newton iteration (csrc/newton.cuh): junction limiting, device
    evaluations (diode 12, +7 for the transient companion; BJT 134; MOSFET
    66, +75 for the three differenced currents of levels 2/3, +50 for the
    Meyer charges of a transient), the build, the solve and the
    convergence test (6 per row); an OP adds the gmin diagonal."""
    n_d, n_q, n_m = plan.counts[5:]
    tran = plan.mode == "tran"
    levels = np.asarray(plan.idx["M"]["level"]) if n_m else np.zeros(0)
    dev = (n_d * (8 + 12 + (7 if tran else 0)) + n_q * (18 + 134)
           + sum(6 + 66 + (75 if lv in (2, 3) else 0) + (50 if tran else 0)
                 for lv in levels))
    return (dev + build_flops(plan, plan.entries) + lu_flops(plan.np1)
            + 6 * plan.np1 + (0 if tran else plan.np1 - 1))


def stamped_flops(pat):
    """One stamped solve: an add per term and per gmin diagonal, then the
    elimination."""
    return int(pat.table[0]) + pat.n - 1 + lu_flops(pat.n)


def ac_flops(np1):
    """One AC lane: the N^2 products omega·B^, then the N x N complex
    system (G + j·omega·B^) x = r that the kernel's real 2N block system
    [[G, -omega·B^], [omega·B^, G]] embeds."""
    return np1 * np1 + complex_lu_flops(np1)


def timed_call(fn, *args):
    """(result, ms) of one call between CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    r = fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return r, e0.elapsed_time(e1)


def bound(flops, nbytes):
    op_ms = flops / PEAK_F64 * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms
                                 else "bytes"), op_ms, byte_ms


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


# ---------------------------------------------------------- comparisons


def compare_run(name, k, p, check_jv=False):
    """Exact counters; t_final, dt_final and the state (and jv) bit for bit,
    and within RTOL; max abs err."""
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        a, b = getattr(k, key), getattr(p, key)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"{name}: {key} differs on {bad} lanes")
    pairs = [("t_final", k.t, p.t), ("state", k.state, p.state)]
    if check_jv:
        pairs.append(("jv", k.jv, p.jv))
    for what, a, b in pairs + [("dt_final", k.dt, p.dt)]:
        if not same_bits(a, b):
            fail(f"{name}: {what} is not bit for bit the plain version's")
    return max_err(name, pairs)


def exact_err(name, pairs):
    """max_err, each (what, a, b) also bit for bit (the OP and DC sweep
    kernels against their plain versions)."""
    for what, a, b in pairs:
        if not same_bits(a, b):
            fail(f"{name}: {what} is not bit for bit the plain version's")
    return max_err(name, pairs)


def max_err(name, pairs):
    """Each (what, a, b): a within RTOL of b's largest finite magnitude
    (per column of a 2-D b), non-finite where b is; the max abs err."""
    return max((check_err(name, what, a, b, err_scale(b))
                for what, a, b in pairs), default=0.0)


def err_scale(b):
    fin = torch.isfinite(b)
    scale = torch.where(fin, b.abs(), 0.0)
    return scale.amax(dim=0, keepdim=True) if b.ndim == 2 else scale.amax()


def check_err(name, what, a, b, scale):
    same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
    fin = torch.isfinite(b)
    d = torch.where(fin, (a - b).abs(), 0.0)
    if not same_nan or bool((d > RTOL * scale).any()) or not bool(
            (torch.isfinite(a) == fin).all()):
        fail(f"{name}: {what} differs beyond rtol {RTOL} "
             f"(max abs {float(d.max()):.3e})")
    return float(d.max())


def wave_err(name, kw, pw, block=1024):
    """max_err over out_x (every lane's rows as one (B·max_store, np1)
    table) and out_t, a block of lanes at a time against the scale of all
    of them, so that no temporary outgrows a block; each block bit for bit
    too."""
    b, m, n = kw.out_x.shape
    for i in range(0, b, block):
        if not (same_bits(kw.out_x[i:i + block], pw.out_x[i:i + block])
                and same_bits(kw.out_t[i:i + block], pw.out_t[i:i + block])):
            fail(f"{name}: the stored rows of lanes {i}.. are not bit for "
                 "bit the plain version's")
    parts = (("out_x", lambda w, i: w.out_x[i:i + block].reshape(-1, n)),
             ("out_t", lambda w, i: w.out_t[i:i + block]))
    err = 0.0
    for what, part in parts:
        scale = torch.stack([err_scale(part(pw, i))
                             for i in range(0, b, block)]).amax(dim=0)
        for i in range(0, b, block):
            err = max(err, check_err(name, what, part(kw, i), part(pw, i),
                                     scale))
    return err


class TimedSolve:
    """A launch function with CUDA events around every launch; ``args``
    keeps each call's arguments.  With ``library``, each call also times
    torch.linalg.solve on the call's systems (``library(*args)`` -> (a,
    b)) under events of its own."""

    def __init__(self, solve, library=None):
        self.solve = solve
        self.library = library
        self.events, self.lib_events = [], []
        self.args = []

    def __call__(self, *args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = self.solve(*args)
        e1.record()
        self.events.append((e0, e1))
        self.args.append(args)
        if self.library is not None:
            a_, b_ = self.library(*args)
            l0 = torch.cuda.Event(enable_timing=True)
            l1 = torch.cuda.Event(enable_timing=True)
            l0.record()
            torch.linalg.solve(a_, b_)
            l1.record()
            self.lib_events.append((l0, l1))
        return r

    def ms(self, lib=False):
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in
                   (self.lib_events if lib else self.events))


def stamped_phases(lanes):
    """Phase 8: the linear OP and the linear DC sweep through the stamped-solve
    kernel, then the kernel against its plain version."""
    def r_only(cc, b):
        return perturbed(cc, np.random.default_rng(0), b, ("R",))

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("divider_op.cir"), r_only,
                                        lanes)
    ts.run_op_batch(cc, params, axes)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    opr = ts.run_op_batch(cc, params, axes)
    torch.cuda.synchronize()
    op_wall = time.perf_counter() - w0
    got = counts()
    check_counts("linear OP main path", got, {"stamped_solve": (1, 1)})
    st_launches = got["stamped_solve"]
    ra, rb = (params["R"]["value"][:, k] for k in (0, 1))
    want = 12.0 * rb / (ra + rb)
    if not (bool(opr.converged.all()) and bool((opr.stage == 0).all())
            and bool(((opr.x[:, 2] - want).abs()
                      <= 1e-12 * want.abs()).all())):
        fail("linear OP: a lane did not converge at stage 0 or V(mid) is "
             "not 12·Rb/(Ra + Rb)")
    tk = TimedSolve(solve_stamped.solve_lanes)
    tp_ = TimedSolve(solve_stamped.solve_plain)
    k = make_op(cc, DEFAULTS, solve=tk)(params, state0)
    p = make_op(cc, DEFAULTS, solve=tp_)(params, state0)
    for key in ("converged", "stage"):
        if not torch.equal(getattr(k, key), getattr(p, key)):
            fail(f"linear OP: {key} differs from the plain version")
    st_err = max_err("linear OP", [("x", k.x, p.x), ("x", opr.x, p.x)])
    st_ms, st_pms = tk.ms(), tp_.ms()
    systems = [tk.args[0]]
    phase("8 linear OP", t0,
          f"divider_op: {lanes} lanes, np1={cc.np1}, stamped-solve "
          f"launches={st_launches}, converged {int(opr.converged.sum())} at "
          f"stage 0, wall={op_wall:.6f} s; kernel vs plain equal, max abs "
          f"err {st_err:.3e}; kernel {st_ms:.3f} ms, plain {st_pms:.1f} ms")

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(DIVIDER_DC, r_only, lanes)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    ts.run_dc_batch(cc, (0,), params, axes, pts)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts)
    torch.cuda.synchronize()
    ldc_wall = time.perf_counter() - w0
    got = counts()
    check_counts("linear DC main path", got, {"stamped_solve": (1, 1)})
    st_launches += got["stamped_solve"]
    ra, rb = (params["R"]["value"][:, k] for k in (0, 1))
    want = torch.as_tensor(pts, device=ra.device)[None] * (
        rb / (ra + rb))[:, None]
    if xs.shape != (lanes, len(pts), cc.np1) or not bool(
            conv.all()) or not bool(((xs[..., 2] - want).abs()
                                     <= 1e-12 * want.abs().amax()).all()):
        fail("linear DC: wrong shape, a point not converged, or V(mid) is "
             "not Vin·R2/(R1 + R2)")
    tk = TimedSolve(solve_stamped.solve_lanes)
    tp_ = TimedSolve(solve_stamped.solve_plain)
    xk, ck = make_dc(cc, (0,), DEFAULTS, solve=tk)(params, state0, pts)
    xp, cp = make_dc(cc, (0,), DEFAULTS, solve=tp_)(params, state0, pts)
    if not torch.equal(ck, cp):
        fail("linear DC: conv differs from the plain version")
    ldc_err = max_err("linear DC", [("xs", xk.reshape(-1, cc.np1),
                                     xp.reshape(-1, cc.np1)),
                                    ("xs", xs.reshape(-1, cc.np1),
                                     xp.reshape(-1, cc.np1))])
    st_err = max(st_err, ldc_err)
    dk_ms, dp_ms = tk.ms(), tp_.ms()
    st_ms, st_pms = st_ms + dk_ms, st_pms + dp_ms
    systems.append(tk.args[0])
    lib_ms = 0.0
    st_flops = st_bytes = 0
    for pat, vals, rvals, gmin in systems:
        m = solve_stamped.build_plain(pat, vals, rvals, gmin)
        a_, b_ = m[:, :, :pat.n].contiguous(), m[:, :, pat.n:].contiguous()
        torch.linalg.solve(a_, b_)  # warm-up
        _, ms = timed_call(torch.linalg.solve, a_, b_)
        lib_ms += ms
        st_flops += vals.shape[0] * stamped_flops(pat)
        st_bytes += nbytes(vals, rvals, gmin) + pat.table.nbytes \
            + vals.shape[0] * pat.n * 8
    stamped = dict(launches=st_launches, err=st_err, k_ms=st_ms,
                   p_ms=st_pms, lib_ms=lib_ms, flops=st_flops,
                   nbytes=st_bytes, systems=[v.shape[0] for _, v, _, _ in
                                             systems])
    phase("8 linear DC", t0,
          f"divider sweep: {lanes} lanes x {len(pts)} points = "
          f"{lanes * len(pts)} systems in one stamped-solve launch, "
          f"all converged, wall={ldc_wall:.6f} s; kernel vs plain equal, "
          f"max abs err {ldc_err:.3e}; kernel {dk_ms:.3f} ms, plain "
          f"{dp_ms:.1f} ms; torch.linalg.solve on the OP's and the sweep's "
          f"systems {lib_ms:.3f} ms")
    return stamped


def rsen_is(cc, b):
    """R, then the diode's Is, spread 0.1, numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    ov = perturbed(cc, rng, b, ("R",))
    is_ = np.asarray(cc.params["D"]["is_"])
    ov["D"] = {"is_": is_[None] * np.exp(rng.normal(0.0, 0.1,
                                                    (b, len(is_))))}
    return ov


def dc_phase(lanes):
    """Phase 9: the DC sweep main path and the DC sweep kernel against its
    plain version."""
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("diode_iv_sweep.cir"),
                                        rsen_is, lanes)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    if len(pts) != 35:
        fail(f"diode_iv_sweep: {len(pts)} sweep points, expected 35")
    slot = (cc.names["V"].index(d.source1),)
    ts.run_dc_batch(cc, slot, params, axes, pts)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xs, conv = ts.run_dc_batch(cc, slot, params, axes, pts)
    torch.cuda.synchronize()
    dc_wall = time.perf_counter() - w0
    got = counts()
    check_counts("DC sweep main path", got, {"dc_sweep_kernel": (1, 1)})
    dc_launches = got["dc_sweep_kernel"]
    # the diode current I(Vb) = -x[branch] rises with the sweep
    i_b = -xs[..., cc.np1 - 1]
    if xs.shape != (lanes, 35, cc.np1) or not bool(conv.all()) or \
            not bool(torch.isfinite(xs).all()) or not bool(
                (i_b[:, 1:] > i_b[:, :-1]).all()):
        fail("DC sweep: wrong shape, a point not converged or not finite, "
             "or the diode current not rising")
    tk = TimedSolve(dc.dc_lanes)
    tp_ = TimedSolve(dc.dc_plain)
    k = dc.make_dc_fused(cc, slot, DEFAULTS, solve=tk)(params, state0, pts)
    p = dc.make_dc_fused(cc, slot, DEFAULTS, solve=tp_)(params, state0, pts)
    for key in ("conv", "iters"):
        if not torch.equal(getattr(k, key), getattr(p, key)):
            fail(f"DC sweep: {key} differs from the plain version")
    dc_err = exact_err("DC sweep", [
        ("xs", k.xs.reshape(-1, cc.np1), p.xs.reshape(-1, cc.np1)),
        ("xs", xs.reshape(-1, cc.np1), p.xs.reshape(-1, cc.np1))])
    dk_ms, dp_ms = tk.ms(), tp_.ms()
    plan_dc, dev_, dyn_, vs_, _ = tk.args[0]
    dc_iters = int(k.iters.sum())
    dc_main = dict(launches=dc_launches, err=dc_err, k_ms=dk_ms, p_ms=dp_ms,
                   plan=plan_dc, iters=dc_iters,
                   nbytes=nbytes(dev_, dyn_, vs_, k.xs) + plan_dc.topo.nbytes
                   + lanes * len(pts) * 8)
    phase("9 DC sweep", t0,
          f"diode_iv_sweep: {lanes} lanes x {len(pts)} points in one "
          f"launch, np1={cc.np1}, all converged, Newton iterations "
          f"{dc_iters} ({dc_iters / (lanes * len(pts)):.6f} per "
          f"point), wall={dc_wall:.6f} s; kernel vs plain equal, bit for "
          f"bit, max abs err {dc_err:.3e}; kernel {dk_ms:.3f} ms, plain "
          f"{dp_ms:.1f} ms")
    return dc_main


def ac_phase(lanes):
    """Phase 10: the AC main path and the AC kernel against its plain
    version."""
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("ce_amplifier_ac.cir"),
                                        rc_spread, lanes)
    a = cc.netlist.ac
    freqs = ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)
    ts.run_ac_batch(cc, params, axes, freqs)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs)
    torch.cuda.synchronize()
    ac_wall = time.perf_counter() - w0
    got = counts()
    check_counts("AC main path", got, {"op_kernel": (1, 1 << 30),
                                       "ac_kernel": (1, 1)})
    ac_launches = got["ac_kernel"]
    nf = len(freqs)
    if xr.shape != (lanes, nf, cc.np1) or not bool(
            opr.converged.all()) or not bool(
                torch.isfinite(xr).all() & torch.isfinite(xi).all()):
        fail("AC: wrong shape, a bias not converged, or a value not finite")
    # the AC source's node is the source's phasor, 1 + 0j, at every lane
    # and frequency
    sig = cc.netlist.nodes["sig"]
    if not (bool(((xr[..., sig] - 1.0).abs() <= 1e-12).all())
            and bool((xi[..., sig].abs() <= 1e-12).all())):
        fail("AC: V(sig) is not the source's 1 + 0j")
    tk = TimedSolve(ac.launch_ac_kernel)
    tp_ = TimedSolve(ac.ac_plain)
    kr, ki, _ = make_ac_batch(cc, axes, DEFAULTS, ac_solve=tk)(
        params, state0, freqs)
    pr, pi_, _ = make_ac_batch(cc, axes, DEFAULTS, ac_solve=tp_)(
        params, state0, freqs)
    n2 = 2 * cc.np1
    ac_err = max_err("AC", [
        ("xr", kr.reshape(-1, cc.np1), pr.reshape(-1, cc.np1)),
        ("xi", ki.reshape(-1, cc.np1), pi_.reshape(-1, cc.np1)),
        ("xr", xr.reshape(-1, cc.np1), pr.reshape(-1, cc.np1))])
    if not all(same_bits(a, b) for a, b in ((kr, pr), (ki, pi_), (xr, pr),
                                            (xi, pi_))):
        fail("AC: the kernel is not bit-identical to its plain version")
    ak_ms, ap_ms = tk.ms(), tp_.ms()
    g_, bh_, r_, om_ = tk.args[0]
    m = ac.build_systems(g_, bh_, r_, om_)
    a_, b_ = m[:, :, :n2].contiguous(), m[:, :, n2:].contiguous()
    torch.linalg.solve(a_, b_)  # warm-up
    _, ac_lib_ms = timed_call(torch.linalg.solve, a_, b_)
    ac_main = dict(launches=ac_launches, err=ac_err, k_ms=ak_ms, p_ms=ap_ms,
                   lib_ms=ac_lib_ms,
                   flops=lanes * nf * ac_flops(cc.np1),
                   nbytes=nbytes(g_, bh_, r_, om_)
                   + lanes * nf * n2 * 8)
    phase("10 AC", t0,
          f"ce_amplifier_ac: {lanes} lanes x {nf} frequencies = "
          f"{lanes * nf} systems of {n2}, OP kernel launches "
          f"{got['op_kernel']} (stages "
          f"{torch.bincount(opr.stage.long(), minlength=3).tolist()}), AC "
          f"kernel launches {ac_launches}, wall={ac_wall:.6f} s; kernel vs "
          f"plain bit-identical, max abs err {ac_err:.3e}; kernel "
          f"{ak_ms:.3f} ms, plain "
          f"{ap_ms:.1f} ms, torch.linalg.solve {ac_lib_ms:.3f} ms on the "
          f"same systems ({'no slower' if ak_ms <= ac_lib_ms else 'slower'}"
          ")")
    return ac_main


def run_timed(plan, dev, src, st, sc, jv0=None):
    """The run kernel, timed with CUDA events after a warm-up launch."""
    run.launch_run_kernel(plan, dev, src, st, sc, jv0)  # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    k = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
    e1.record()
    torch.cuda.synchronize()
    return k, e0.elapsed_time(e1)


def plain_timed(plan, dev, src, st, sc, jv0=None):
    """The run kernel's plain version, timed on the host clock."""
    p0 = time.perf_counter()
    p = run.run_plain(plan, dev, src, st, sc, jv0)
    torch.cuda.synchronize()
    return p, (time.perf_counter() - p0) * 1e3


def kernel_vs_plain(plan, dev, src, st, sc, jv0=None):
    """The run kernel and its plain version on the same lanes."""
    return (*run_timed(plan, dev, src, st, sc, jv0),
            *plain_timed(plan, dev, src, st, sc, jv0))


def free():
    """Let the card's allocator give back what the caller dropped."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def magnetic_phases(lanes, main_lanes, smi):
    """Phases 11 and 12: the run kernel's magnetic instantiation against
    its plain version, and the magnetic main path."""
    err = 0.0
    for name, keys in (("coupled_inductors", ("R", "L")),
                       ("saturating_transformer", ("R",))):
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(
            deck_file(f"{name}.cir"),
            lambda cc, b: perturbed(cc, np.random.default_rng(2), b, keys),
            lanes)
        plan, dev, src, st, sc, _ = lane_inputs(cc, cfg, params, state0)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc)
        e = compare_run(name, k, p)
        err = max(err, e)
        if bool(k.fail.any()) or not bool((k.t == cfg.tstop).all()):
            fail(f"{name}: a lane failed or stopped before tstop")
        phase("11 magnetic kernel vs plain", t0,
              f"{name}: {lanes} lanes, np1={plan.np1}, {plan.nlm} LM, "
              f"{plan.nk} K, accepted {int(k.accepted.sum())}, attempts "
              f"{int(k.attempts.sum())}, failed 0; counters equal, bit for "
              f"bit, max abs err {e:.3e}; kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms")

    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("saturating_transformer.cir"),
        lambda cc, b: perturbed(cc, np.random.default_rng(0), b, ("R",)),
        main_lanes)
    fn = ts.make_tran_batch(cc, cfg, axes, store="none")
    fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("magnetic main path", got, {"run_kernel": (1, 1)})
    if fn.engine != "run":
        fail(f"magnetic main path engine {fn.engine!r}, expected 'run'")
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"magnetic main path: {failed} of {main_lanes} lanes failed "
             "or stopped early")
    plan, dev, src, st, sc, _ = lane_inputs(cc, cfg, params, state0)
    k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc)
    e = compare_run("saturating_transformer_8192", k, p)
    err = max(err, e)
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.t_final, k.t)):
        fail("magnetic main path differs from the kernel on its lanes")
    accepted = int(out.accepted.sum())
    phase("12 magnetic main path", t0,
          f"saturating_transformer: engine={fn.engine}, run kernel "
          f"launches={got['run_kernel']}, lanes={main_lanes}, "
          f"accepted={accepted}, attempts={int(out.attempts.sum())}, "
          f"failed={failed}, wall={wall:.6f} s, {accepted / wall:.6e} "
          f"accepted steps/s on {smi}; the same lanes through the kernel "
          f"and its plain version: counters equal, bit for bit, max abs err "
          f"{e:.3e}; "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
    return err


def store_vs_plain(name, plan, dev, src, st, sc, keep, jv0=None):
    """The store instantiation and its plain version on the same lanes.
    The kernel is timed twice with CUDA events: around the wrapper, which
    allocates and zeroes the outputs, and around the launch alone, into
    zeroed buffers given as ``out`` (its result must equal the wrapper's
    bit for bit); the plain version on the host clock.  Their counters,
    out_n and overflow must be equal, and out_x, out_t and the state bit for
    bit.  Returns (kernel result, waveforms, max abs err, launch ms,
    wrapper ms, plain ms)."""
    # warm-up; its outputs go back to the allocator's cache, so the timed
    # wrapper below allocates them again without a cudaMalloc
    run.launch_store_kernel(plan, dev, src, st, sc, keep, jv0)
    (k, kw), w_ms = timed_call(run.launch_store_kernel, plan, dev, src, st,
                               sc, keep, jv0)
    buf = run.Waveforms(torch.zeros_like(kw.out_x),
                        torch.zeros_like(kw.out_t), None, None)
    torch.cuda.synchronize()
    (k2, kw2), k_ms = timed_call(lambda: run.launch_store_kernel(
        plan, dev, src, st, sc, keep, jv0, out=buf))
    if not all(torch.equal(a, b) for a, b in zip(k + kw, k2 + kw2)):
        fail(f"{name}: the launch into given buffers differs from the "
             "wrapper's")
    del k2, kw2, buf
    p0 = time.perf_counter()
    p, pw = run.store_plain(plan, dev, src, st, sc, keep, jv0)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - p0) * 1e3
    err = compare_run(name, k, p, check_jv=jv0 is not None)
    for key in ("out_n", "overflow"):
        if not torch.equal(getattr(kw, key), getattr(pw, key)):
            fail(f"{name}: store {key} differs from the plain version")
    err = max(err, wave_err(name, kw, pw))
    del p, pw
    return k, kw, err, k_ms, w_ms, p_ms


def store_phases(lanes, main_lanes, smi, hwr_none):
    """Phases 13 and 14: the store instantiation against its plain version
    and against the run kernel, then the store main path."""
    err = 0.0
    hwr = deck_file("half_wave_rectifier.cir")
    # coupled_inductors runs to its tstop in phase 11 (~23,700 attempts a
    # lane); here its lanes stop at 2000 attempts, as in phase 22, so that
    # the plain store's replay stays short
    decks = (("rc_sin", RC_SIN, ("R", "C"), None),
             ("half_wave_rectifier", hwr, ("R", "C"), None),
             ("coupled_inductors_2000", deck_file("coupled_inductors.cir"),
              ("R", "L"), 2000))
    for name, deck, keys, max_att in decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(
            deck,
            lambda cc, b: perturbed(cc, np.random.default_rng(3), b, keys),
            lanes)
        plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
        if max_att:
            sc = sc._replace(max_attempts=max_att)
        keep = run.Store(cfg.tstart, cfg.max_store)
        k, kw, e, k_ms, _, p_ms = store_vs_plain(name, plan, dev, src, st,
                                                 sc, keep, jv0)
        r = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
        for key in ("accepted", "attempts", "fail", "nr_iters", "t", "dt",
                    "state", "jv"):
            if not torch.equal(getattr(k, key), getattr(r, key)):
                fail(f"{name}: store kernel's {key} differs from the run "
                     "kernel's")
        if not torch.equal(kw.out_n, k.accepted) or bool(kw.overflow.any()):
            fail(f"{name}: out_n is not the accepted count, or overflow")
        err = max(err, e)
        phase("13 store kernel vs plain", t0,
              f"{name}: {lanes} lanes, np1={plan.np1}, max_store "
              f"{cfg.max_store}, stored rows {int(kw.out_n.sum())}; out_n "
              f"and counters equal, state equal to the run kernel's, max "
              f"abs err {e:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        del kw
        free()
    err = max(err, offsets_check(main_lanes))

    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(hwr, rc_spread, main_lanes)
    fn = ts.make_tran_batch(cc, cfg, axes, store="full")
    if fn.engine != "store":
        fail(f"store main path engine {fn.engine!r}, expected 'store'")
    out = fn(params, state0)  # warm-up
    del out
    free()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("store main path", got, {"op_kernel": (1, 1 << 30),
                                          "run_kernel_store": (1, 1)})
    for key in ("accepted", "attempts", "fail", "nr_iters", "t_final",
                "dt_final"):
        if not torch.equal(getattr(out, key), getattr(hwr_none, key)):
            fail(f"store main path: {key} differs from phase 7's "
                 "store='none' run")
    if not torch.equal(out.out_n, out.accepted) or bool(
            out.store_overflow.any()) or not bool(
                torch.isfinite(out.out_x).all()):
        fail("store main path: out_n is not the accepted count, a row "
             "overflowed, or a stored value is not finite")
    ac = cc.node_map["ac"]
    rows = int(out.out_n.sum())
    b, m, n = out.out_x.shape
    gb = (out.out_x.numel() + out.out_t.numel()) * 8 / 1e9
    phase("14 store main path", t0,
          f"half_wave_rectifier: engine={fn.engine}, OP kernel launches="
          f"{got['op_kernel']}, store kernel launches="
          f"{got['run_kernel_store']}, lanes={main_lanes}, counters equal "
          f"to phase 7's store='none' run, stored rows={rows}, wall="
          f"{wall:.6f} s, {rows / wall:.6e} stored rows/s; the output is "
          f"({b}, {m}, {n}) + ({b}, {m}) f64, {gb:.3f} GB, on {smi}")
    # compat takes the sources at the attempt's old time (PLAN.md 2): the
    # row at out_t[i] holds V(ac) = 6 sin(2 pi 1k out_t[i - 1])
    n0 = int(out.out_n[0])
    t_old = torch.cat([torch.zeros_like(out.out_t[0, :1]),
                       out.out_t[0, :n0 - 1]])
    want = 6.0 * torch.sin(2 * np.pi * 1e3 * t_old)
    if not bool(((out.out_x[0, :n0, ac] - want).abs() < 1e-9).all()):
        fail("store main path: V(ac) is not the source's waveform")
    launches = got["run_kernel_store"]
    del out
    free()

    t0 = time.perf_counter()
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
    keep = run.Store(cfg.tstart, cfg.max_store)
    k, kw, e, k_ms, w_ms, p_ms = store_vs_plain(
        "half_wave_rectifier_full", plan, dev, src, st, sc, keep, jv0)
    err = max(err, e)
    attempts = int(k.attempts.sum())
    nri = int(k.nr_iters.sum())
    nbytes_ = (nbytes(dev, src, st, jv0) + nbytes(st, jv0)
               + plan.topo.nbytes + main_lanes * (8 + 8 + 4 + 4 + 4 + 4)
               + nbytes(kw.out_x, kw.out_t, kw.out_n, kw.overflow))
    phase("14 store kernel vs plain", t0,
          f"half_wave_rectifier: {main_lanes} lanes, counters and out_n "
          f"equal, bit for bit, max abs err {e:.3e}; kernel {k_ms:.3f} ms "
          f"(the launch into zeroed buffers), {w_ms:.3f} ms (the wrapper: "
          f"it also zeroes the {gb:.3f} GB output), plain {p_ms:.1f} ms")
    del kw
    free()
    return dict(launches=launches, err=err, k_ms=k_ms, w_ms=w_ms, p_ms=p_ms,
                plan=plan, attempts=attempts, nri=nri, nbytes=nbytes_)


def offsets_check(lanes):
    """Phase 13, 64-bit offsets: ``lanes`` lanes of an RC ladder with 11
    rows keep their rows past element 2^31 of out_x; the kernel's rows of
    the lanes from just below that element to the last one against the
    plain version run on those lanes alone."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        LADDER,
        lambda cc, b: perturbed(cc, np.random.default_rng(5), b, ("R", "C")),
        lanes)
    plan, dev, src, st, sc, _ = lane_inputs(cc, cfg, params, state0)
    keep = run.Store(cfg.tstart, cfg.max_store)
    per_lane = cfg.max_store * plan.np1
    cross = (1 << 31) // per_lane  # the lane whose block holds element 2^31
    if lanes * per_lane <= 1 << 31:
        fail("64-bit offsets: the store does not reach element 2^31")
    k, kw = run.launch_store_kernel(plan, dev, src, st, sc, keep)
    if not torch.equal(kw.out_n, k.accepted) or bool(kw.overflow.any()) \
            or bool(k.fail.any()):
        fail("64-bit offsets: out_n is not the accepted count, a row "
             "overflowed, or a lane failed")
    lo = max(cross - 64, 0)
    p, pw = run.store_plain(plan, dev[lo:], src[lo:], st[lo:], sc, keep)
    ks = run.RunResult(*(x[lo:] for x in k))
    kws = run.Waveforms(*(x[lo:] for x in kw))
    err = compare_run("ladder_offsets", ks, p)
    if not (torch.equal(kws.out_n, pw.out_n)
            and torch.equal(kws.overflow, pw.overflow)):
        fail("64-bit offsets: out_n or overflow differs from the plain "
             "version")
    err = max(err, wave_err("ladder_offsets", kws, pw))
    elems = lanes * per_lane
    last = (lanes - 1) * per_lane + (int(kw.out_n[-1]) - 1) * plan.np1
    phase("13 store kernel, 64-bit offsets", t0,
          f"rc_ladder: {lanes} lanes, np1={plan.np1}, max_store "
          f"{cfg.max_store}: out_x has {elems} elements (2^31 = "
          f"{1 << 31}), lane {cross} holds element 2^31; lanes {lo}.."
          f"{lanes - 1} ({int(kws.out_n.sum())} stored rows, the last at "
          f"element {last}) equal to the plain version on those lanes: "
          f"out_n and counters equal, bit for bit, max abs err {err:.3e}")
    del kw, kws, pw
    free()
    return err


def stream_phase(main_lanes, lanes, smi, bench, bench_none,
                 bench_overrides):
    """Phase 15: the streamed main path on bench.py's deck against one
    monolithic store launch, then the host stitch at ``lanes`` lanes."""
    chunk = 4096
    t0 = time.perf_counter()
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, bench_overrides(cc, main_lanes))
    state0 = ts.init_state(cc)
    fns = ts.make_tran_stream(cc, cfg, chunk)
    for _ in ts.stream_transient_chunks(cc, cfg, params, state0, chunk,
                                        fns=fns):
        pass  # warm-up
    free()
    reset_counts()
    w0 = time.perf_counter()
    n_chunks = 0
    for out in ts.stream_transient_chunks(cc, cfg, params, state0, chunk,
                                          fns=fns):
        n_chunks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("streamed main path", got,
                 {"run_kernel_store": (n_chunks, n_chunks)})
    del out
    free()

    # one monolithic store launch of the same lanes against its plain
    # version, timed against the store='none' kernel of phase 3 (the same
    # call)
    plan, dev, src, st = bench["plan"], bench["dev"], bench["src"], \
        bench["st"]
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    keep = run.Store(cfg.tstart, cfg.max_store)
    mono, mw, err, mono_ms, mono_w_ms, mono_p_ms = store_vs_plain(
        "bench_rlc_full", plan, dev, src, st, sc, keep)
    free()
    b, m, n = mw.out_x.shape
    mono_gb = (mw.out_x.numel() + mw.out_t.numel()) * 8 / 1e9
    acc = torch.zeros_like(mono.accepted)
    offs = torch.zeros(b, dtype=torch.long, device=acc.device)
    rows = 0
    last = None
    j = torch.arange(chunk, device=acc.device)[None, :]
    for out in ts.stream_transient_chunks(cc, cfg, params, state0, chunk,
                                          fns=fns):
        cn = out.out_n.long()
        valid = j < cn[:, None]
        idx = torch.clamp(offs[:, None] + j, max=m - 1)
        want_t = torch.gather(mw.out_t, 1, idx)
        want_x = torch.gather(mw.out_x, 1, idx[:, :, None].expand(-1, -1, n))
        if not (torch.equal(torch.where(valid, out.out_t, 0.0),
                            torch.where(valid, want_t, 0.0))
                and torch.equal(torch.where(valid[:, :, None], out.out_x,
                                            0.0),
                                torch.where(valid[:, :, None], want_x,
                                            0.0))):
            fail("streamed main path: a chunk differs from the monolithic "
                 "store's rows")
        del want_t, want_x
        offs += cn
        rows += int(cn.sum())
        acc += out.accepted
        last = out
    if not torch.equal(offs.to(torch.int32), mw.out_n):
        fail("streamed main path: the chunks' rows are not the monolithic "
             "out_n")
    for key, a, want in (("accepted", acc, bench_none.accepted),
                         ("attempts", last.attempts, bench_none.attempts),
                         ("t_final", last.t_final, bench_none.t_final),
                         ("accepted (monolithic)", mono.accepted,
                          bench_none.accepted)):
        if not torch.equal(a, want):
            fail(f"streamed main path: {key} differs from phase 4's run")
    accepted = int(acc.sum())
    phase("15 streamed main path", t0,
          f"bench_rlc: {main_lanes} lanes, chunk_store={chunk}, "
          f"{n_chunks} chunks, store kernel launches="
          f"{got['run_kernel_store']}, stored rows={rows}, every chunk "
          f"equal to the monolithic store's rows, totals equal to phase 4's, "
          f"wall={wall:.6f} s, {accepted / wall:.6e} accepted steps/s on "
          f"{smi}; the monolithic store launch {mono_ms:.3f} ms into "
          f"zeroed buffers, {mono_w_ms:.3f} ms through the wrapper (({b}, "
          f"{m}, {n}) + ({b}, {m}) f64, {mono_gb:.3f} GB), against "
          f"{bench['k_ms']:.3f} ms for the store='none' kernel in phase 3; "
          f"its plain version {mono_p_ms:.1f} ms, out_n and counters equal, "
          f"max abs err {err:.3e}")
    del mw, last, out
    free()
    # the bound of the streamed run's store launches: each kept row (np1
    # values and its time) written once, the inputs read once, the state
    # and counters written once; the attempts' operations
    flops = bench["attempts"] * attempt_flops(plan)
    nbytes_ = (nbytes(dev, src, st) + plan.topo.nbytes + nbytes(st)
               + main_lanes * (8 + 8 + 4 + 4 + 4 + 4 + 4 + 4)
               + rows * (n + 1) * 8)

    t0 = time.perf_counter()
    params, axes = ts.batch_params(cc, bench_overrides(cc, lanes))
    so = ts.run_transient_streamed(cc, cfg, params, state0, chunk)
    whole = ts.make_tran_batch(cc, cfg, axes, store="full")(params, state0)
    nmax = int(so.out_n.max())
    if not (torch.equal(so.out_n, whole.out_n.cpu())
            and torch.equal(so.out_x, whole.out_x[:, :nmax].cpu())
            and torch.equal(so.out_t, whole.out_t[:, :nmax].cpu())
            and torch.equal(so.accepted, whole.accepted)
            and torch.equal(so.attempts, whole.attempts)):
        fail("run_transient_streamed differs from the monolithic run")
    phase("15 streamed host stitch", t0,
          f"bench_rlc: {lanes} lanes, run_transient_streamed with "
          f"chunk_store={chunk} stitched on the host into ({lanes}, {nmax}, "
          f"{cc.np1}), equal to the monolithic store='full' run bit for "
          "bit")
    del so, whole
    free()
    return dict(mono_ms=mono_ms, chunks=n_chunks, rows=rows, err=err,
                flops=flops, nbytes=nbytes_)


def resume_phase(lanes, bench_overrides):
    """Phase 16: a run cut at half its attempts and resumed from its state,
    t, dt and attempt count equals the one-piece run."""
    t0 = time.perf_counter()
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, bench_overrides(cc, lanes))
    state0 = ts.init_state(cc)
    whole = ts.make_tran_batch(cc, cfg, axes)(params, state0)
    half = int(whole.attempts.max()) // 2
    reset_counts()
    leg1 = ts.make_tran_batch(cc, cfg._replace(max_attempts=half), axes)(
        params, state0)
    fn = ts.make_tran_batch(cc, cfg, axes, resume=True)
    rest = fn(params, leg1.state, leg1.t_final, leg1.jv, leg1.dt_final,
              leg1.attempts)
    torch.cuda.synchronize()
    got = counts()
    check_counts("resume", got, {"run_kernel": (1, 1),
                                 "run_kernel_store": (1, 1)})
    same = (torch.equal(rest.attempts, whole.attempts)
            and torch.equal(leg1.accepted + rest.accepted, whole.accepted)
            and torch.equal(rest.t_final, whole.t_final)
            and torch.equal(rest.dt_final, whole.dt_final)
            and all(torch.equal(rest.state[kd][key], whole.state[kd][key])
                    for kd in whole.state for key in whole.state[kd]))
    if not same or bool((leg1.t_final >= cfg.tstop).any()):
        fail("resume: the two legs differ from the one-piece run")
    phase("16 resume", t0,
          f"bench_rlc: {lanes} lanes cut at {half} attempts (t = "
          f"{float(leg1.t_final.min()):.6e}..{float(leg1.t_final.max()):.6e}"
          f" s), resumed with their state, t, dt and attempts: counters, "
          f"t_final, dt_final and state equal to the one-piece run; run "
          f"kernel launches {got['run_kernel']}, store kernel launches "
          f"{got['run_kernel_store']} (the resumed leg)")


# ------------------------------------------------------------ physics
# Physics semantics: the PHYS instantiations of the run kernel and its
# store, and the physics flavours of the OP and DC sweep kernels.


def phys_newton_flops(plan, rs_share=0.0):
    """One physics Newton iteration: newton_flops with the physics diode
    (the breakdown-frame gate 3, the eval with its breakdown exponential
    22, the companions from the committed rows 9) and, on the share of
    lanes whose Rs is not 0, its 8-step inner Newton (8 evaluations of 26
    and a seed of 16); a MOSFET's companions add 10."""
    n_d, _, n_m = plan.counts[5:]
    tran = plan.mode == "tran"
    extra = n_d * (3 + 22 - 12 + (9 - 7 if tran else 0)
                   + rs_share * (8 * 26 + 16)) + (n_m * 10 if tran else 0)
    return newton_flops(plan) + extra


def phys_step_flops(plan, rs_share=0.0):
    """A physics attempt's work around its solve: step_flops, the
    trapezoidal C/L companions (6 each), the capacitor current's commit
    (5), and the commit's re-evaluation of each diode (28, and its Rs
    steps on their share) and MOSFET (75)."""
    nc, nl, n_d, _, n_m = plan.counts[1], plan.counts[2], *plan.counts[5:]
    return (step_flops(plan) + 11 * nc + 6 * nl
            + n_d * (28 + rs_share * (8 * 26 + 16)) + 75 * n_m)


def physics_run_phase(lanes):
    """Phase 18: the PHYS run kernel and its store instantiation against
    their plain versions (counters, out_n equal; state, jv, waveforms
    bit for bit), and the store's counters and state equal to the run
    kernel's."""
    hwr = deck_file("half_wave_rectifier.cir")
    # cut in depth so that the plain versions' replay stays short: the
    # NMOS inverter's 0.4 ms is two periods of its gate pulse (0.2 ms, one;
    # its lanes stop at 120 of their 206 attempts, past the first edges);
    # rlc_ringdown takes ~20,800 attempts per lane to its tstop whatever
    # the tstop (build_config ties the steps to tstop / 300), so its lanes
    # stop at 1000 attempts
    nmos = deck_file("nmos_inverter_tran.cir").replace(".tran 1u 0.4m",
                                                       ".tran 1u 0.2m")
    decks = (("half_wave_rectifier", hwr, False, None),
             ("half_wave_rectifier", hwr, True, None),
             ("d_rs_sin", D_RS_SIN, True, None),
             ("d_bv_sin", D_BV_SIN, True, None),
             ("nmos_inverter_tran_0.2m", nmos, True, 120),
             ("bjt_ce_tran", BJT_TRAN, False, None),
             ("rlc_ringdown_1000", deck_file("rlc_ringdown.cir"), True,
              1000))
    run_err = store_err = 0.0
    for name, deck, trap, max_att in decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(
            deck, lambda cc, b: perturbed(cc, np.random.default_rng(4), b,
                                          ("R", "C")), lanes)
        plan, dev, src, st, sc, jv0 = lane_inputs(
            cc, cfg, params, state0,
            ts.SimOptions(integration="trap" if trap else "be"), "physics")
        if max_att:
            sc = sc._replace(max_attempts=max_att)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
        e = compare_run(name, k, p, check_jv=jv0 is not None)
        run_err = max(run_err, e)
        keep = run.Store(cfg.tstart, cfg.max_store)
        ks, kw, es, s_ms, _, sp_ms = store_vs_plain(name, plan, dev, src,
                                                    st, sc, keep, jv0)
        store_err = max(store_err, es)
        for key in ("accepted", "attempts", "fail", "nr_iters", "t", "dt",
                    "state", "jv"):
            if not torch.equal(getattr(ks, key), getattr(k, key)):
                fail(f"{name}: the PHYS store's {key} differs from the PHYS "
                     "run kernel's")
        if not torch.equal(kw.out_n, k.accepted) or bool(kw.overflow.any()):
            fail(f"{name}: out_n is not the accepted count, or overflow")
        phase("18 physics kernel vs plain", t0,
              f"{name} ({'trap' if trap else 'be'}): {lanes} lanes, "
              f"np1={plan.np1}, ks={plan.ks}, accepted "
              f"{int(k.accepted.sum())}, attempts {int(k.attempts.sum())}, "
              f"NR iterations {int(k.nr_iters.sum())}, failed "
              f"{int(k.fail.sum())}; counters equal"
              f"{'' if plan.nonlinear else ', bit for bit'}, max abs err "
              f"{e:.3e} (run), {es:.3e} (store); kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms; store {s_ms:.3f} ms, plain {sp_ms:.1f} ms")
        del kw
        free()
    return run_err, store_err


def physics_op_phase(lanes):
    """Phase 19: the OP kernel's physics flavour against its plain version
    through make_op_fused (rescue ladders included) on the Rs and Bv
    diodes, ce_amplifier_op.cir and the main path's bias."""
    def r_spread(cc, b):
        return perturbed(cc, np.random.default_rng(0), b, ("R",))

    decks = (("d_rs", D_RS, r_spread),
             ("d_bv", D_BV, r_spread),
             ("ce_amplifier_op", deck_file("ce_amplifier_op.cir"), r_spread),
             ("half_wave_rectifier", deck_file("half_wave_rectifier.cir"),
              rc_spread))
    err, main = 0.0, None
    for name, deck, ov in decks:
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(deck, ov, lanes)
        fk = op.make_op_fused(cc, DEFAULTS, semantics="physics")
        fk(params, state0)  # warm-up
        tk = TimedSolve(op.op_lanes)
        tp_ = TimedSolve(op.op_plain)
        k = op.make_op_fused(cc, DEFAULTS, semantics="physics",
                             solve=tk)(params, state0)
        p = op.make_op_fused(cc, DEFAULTS, semantics="physics",
                             solve=tp_)(params, state0)
        k_ms, p_ms = tk.ms(), tp_.ms()
        for key in ("converged", "stage", "iters", "iters_all"):
            if not torch.equal(getattr(k, key), getattr(p, key)):
                fail(f"{name}: physics OP {key} differs from the plain "
                     "version")
        e = exact_err(name, [("x", k.x, p.x)] + [
            (f"jv.{kd}.{key}", k.jv[kd][key], p.jv[kd][key])
            for kd in k.jv for key in k.jv[kd]])
        err = max(err, e)
        conv = int(k.converged.sum())
        if conv != lanes:
            fail(f"{name}: {lanes - conv} physics OP lanes did not converge")
        phase("19 physics OP kernel vs plain", t0,
              f"{name}: {lanes} lanes, np1={cc.np1}, converged {conv}, NR "
              f"iterations {int(k.iters_all.sum())}, launches "
              f"{len(tk.events)}; equal counts, bit for bit, max abs err "
              f"{e:.3e}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name == "half_wave_rectifier":
            plan_op = fk.plan
            per_lane = 8 * (plan_op.nd + op.dyn_width(plan_op)
                            + 2 * (plan_op.np1 + plan_op.kj)) + 8
            main = dict(k_ms=k_ms, p_ms=p_ms, plan=plan_op,
                        iters=int(k.iters_all.sum()),
                        nbytes=len(tk.events) * (lanes * per_lane
                                                 + plan_op.topo.nbytes))
    main["err"] = err
    return main


def physics_dc_phase(lanes):
    """Phase 20: run_dc_batch under physics on diode_iv_sweep.cir with Rsen,
    Is and the diode's Rs drawn per lane (the Rs inner Newton on every
    lane), one launch of the DC sweep kernel's physics flavour; then the
    kernel against its plain version."""
    def spread(cc, b):
        rng = np.random.default_rng(0)
        ov = perturbed(cc, rng, b, ("R",))
        is_ = np.asarray(cc.params["D"]["is_"])
        ov["D"] = {"is_": is_[None] * np.exp(rng.normal(0.0, 0.1,
                                                        (b, len(is_)))),
                   "rs": rng.uniform(1.0, 20.0, (b, len(is_)))}
        return ov

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("diode_iv_sweep.cir"),
                                        spread, lanes)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    slot = (cc.names["V"].index(d.source1),)
    ts.run_dc_batch(cc, slot, params, axes, pts, semantics="physics")
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xs, conv = ts.run_dc_batch(cc, slot, params, axes, pts,
                               semantics="physics")
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("physics DC sweep main path", got,
                 {"dc_sweep_kernel": (1, 1)})
    i_b = -xs[..., cc.np1 - 1]
    if not bool(conv.all()) or not bool(torch.isfinite(xs).all()) or \
            not bool((i_b[:, 1:] > i_b[:, :-1]).all()):
        fail("physics DC sweep: a point not converged or not finite, or "
             "the diode current not rising")
    tk = TimedSolve(dc.dc_lanes)
    tp_ = TimedSolve(dc.dc_plain)
    k = dc.make_dc_fused(cc, slot, DEFAULTS, "physics", solve=tk)(
        params, state0, pts)
    p = dc.make_dc_fused(cc, slot, DEFAULTS, "physics", solve=tp_)(
        params, state0, pts)
    for key in ("conv", "iters"):
        if not torch.equal(getattr(k, key), getattr(p, key)):
            fail(f"physics DC sweep: {key} differs from the plain version")
    err = exact_err("physics DC sweep", [
        ("xs", k.xs.reshape(-1, cc.np1), p.xs.reshape(-1, cc.np1)),
        ("xs", xs.reshape(-1, cc.np1), p.xs.reshape(-1, cc.np1))])
    k_ms, p_ms = tk.ms(), tp_.ms()
    plan_dc, dev_, dyn_, vs_, _ = tk.args[0]
    iters = int(k.iters.sum())
    phase("20 physics DC sweep", t0,
          f"diode_iv_sweep (physics, Rs per lane): {lanes} lanes x "
          f"{len(pts)} points in one launch, all converged, Newton "
          f"iterations {iters}, wall={wall:.6f} s; kernel vs plain equal, "
          f"bit for bit, max abs err {err:.3e}; kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.1f} ms")
    return dict(launches=got["dc_sweep_kernel"], err=err, k_ms=k_ms,
                p_ms=p_ms, plan=plan_dc, iters=iters,
                nbytes=nbytes(dev_, dyn_, vs_, k.xs) + plan_dc.topo.nbytes
                + lanes * len(pts) * 8)


def physics_main_phase(lanes, smi):
    """Phase 21: the main path half_wave_rectifier_8192_physics_trap:
    make_tran_batch(semantics='physics') with SimOptions(integration=
    'trap'), store='none', non-UIC: one launch of the OP kernel's physics
    flavour, the bias-point seed, one launch of the PHYS run kernel; no
    lane failed; then that kernel on the same inputs against its plain
    version."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("half_wave_rectifier.cir"), rc_spread, lanes)
    opts = ts.SimOptions(integration="trap")
    fn = ts.make_tran_batch(cc, cfg, axes, semantics="physics", opts=opts)
    if fn.engine != "run":
        fail(f"physics main path engine {fn.engine!r}, expected 'run'")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("physics main path", got, {"run_kernel": (1, 1),
                                            "op_kernel": (1, 1)})
    accepted = int(out.accepted.sum())
    attempts = int(out.attempts.sum())
    nri = int(out.nr_iters.sum())
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"physics main path: {failed} of {lanes} lanes failed or "
             "stopped early")
    for kind_ in out.state.values():
        for leaf in kind_.values():
            if leaf.shape[0] != lanes or not bool(torch.isfinite(leaf).all()):
                fail("physics main path state is not finite or has the "
                     "wrong shape")
    if not bool((out.state["D"]["hist"] == 1).all()):
        fail("physics main path: a diode committed no step")
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0, opts,
                                              "physics")
    k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
    err = compare_run("half_wave_rectifier_physics_trap", k, p,
                      check_jv=True)
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.nr_iters, k.nr_iters)
            and torch.equal(out.t_final, k.t)
            and torch.equal(out.jv["D"]["vd"], k.jv)):
        fail("physics main path differs from a kernel run on the same "
             "inputs")
    phase("21 physics main path", t0,
          f"half_wave_rectifier_8192_physics_trap: engine={fn.engine}, "
          f"run kernel launches={got['run_kernel']}, OP kernel launches="
          f"{got['op_kernel']}, lanes={lanes}, accepted={accepted}, "
          f"attempts={attempts} ({attempts / lanes:.6f} per lane), NR "
          f"iterations {nri} ({nri / lanes:.6f} per lane), failed="
          f"{failed}, wall={wall:.6f} s, {accepted / wall:.6e} accepted "
          f"steps/s on {smi}; the kernel on the same inputs against its "
          f"plain version: counters equal, bit for bit, max abs err "
          f"{err:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
    return dict(launches=got["run_kernel"], op_launches=got["op_kernel"],
                err=err, k_ms=k_ms, p_ms=p_ms, plan=plan,
                attempts=int(k.attempts.sum()), nri=int(k.nr_iters.sum()),
                nbytes=nbytes(dev, src, st, jv0) + nbytes(st, jv0)
                + plan.topo.nbytes + lanes * (8 + 8 + 4 + 4 + 4 + 4))


# --------------------------------------------------- physics magnetics
# The live Jiles-Atherton core and the physics mutual (the PHYS MAG
# instantiations of csrc/run_kernel_mag.cu), compat LM and K with a Newton
# (its compat MAG NL ones), and the OP and DC sweep kernels on a magnetic
# deck (each winding's +1e-3 branch diagonal).


def mag_build_extra(plan):
    """A physics build's magnetic work beyond build_flops: each LM stamp's
    incremental L (2) and each K stamp's M = k·sqrt(La·Lb) from the two
    live inductances (7)."""
    tags = plan.entries[:, 2]
    lm = int(np.isin(tags, (run_plan.TAG_LMTERM, run_plan.TAG_LMRHS)).sum())
    k = int(np.isin(tags, (run_plan.TAG_KTERM, run_plan.TAG_KRHSA,
                           run_plan.TAG_KRHSB)).sum())
    return 2 * lm + 7 * k


def ja_commit_flops(plan):
    """An accepted step's live J-A commit: per winding its core's mmf (2
    per winding on the core), H and its clip (3), the J-A step (44: He,
    the anhysteretic with its series or tanh, the irreversible slope, M
    and dM/dH) and the voltage and flux (3)."""
    core = plan.core
    return sum(2 * int((core == c).sum()) + 50 for c in core)


def phys_mag_attempt_flops(plan):
    """A physics linear attempt on a magnetic deck: phys_step_flops, one
    build with its magnetic terms, one solve."""
    return int(phys_step_flops(plan) + build_flops(plan, plan.entries)
               + mag_build_extra(plan) + lu_flops(plan.np1))


def run_bound(plan, k, physics):
    """The operation count of one run kernel result ``k`` on a magnetic
    deck: every attempt's step work, every Newton iteration's (or linear
    attempt's) build and solve, and under physics the J-A commit of every
    accepted step."""
    acc, att, nri = (int(getattr(k, key).sum()) for key in
                     ("accepted", "attempts", "nr_iters"))
    step = phys_step_flops(plan) if physics else step_flops(plan)
    extra = mag_build_extra(plan) if physics else 0
    if plan.nonlinear:
        per = (phys_newton_flops(plan) if physics else newton_flops(plan))
        flops = att * step + nri * (per + extra)
    else:
        flops = att * (step + build_flops(plan, plan.entries) + extra
                       + lu_flops(plan.np1))
    return int(flops + (acc * ja_commit_flops(plan) if physics else 0))


def run_nbytes(plan, dev, src, st, jv0, lanes):
    """Inputs read once, the state and junctions written once, and the
    per-lane counters."""
    jv = () if jv0 is None else (jv0, jv0)
    return (nbytes(dev, src, st, st, *jv) + plan.topo.nbytes
            + lanes * (8 + 8 + 4 + 4 + 4 + 4))


def mag_run_phase(lanes, smi):
    """Phase 22: the PHYS MAG run kernel against its plain version on
    saturating_transformer.cir (BE and trap), coupled_inductors.cir (trap:
    2M/dt on its both-linear pair), TRANS_SMALL and XFMR_MAG (BE), 256
    lanes, R spread, from the linear OP's bias point; then the physics MAG
    store path (make_tran_batch(store='full') on the saturating
    transformer under trap) and its store instantiation against the plain
    store."""
    sat = deck_file("saturating_transformer.cir")
    # coupled_inductors' linear inductor LTE paces every lane near minstep
    # (~23,700 attempts to its 1.5 ms): its lanes stop at 2000 attempts so
    # that the plain version's replay stays short
    decks = (("saturating_transformer", sat, False, None),
             ("saturating_transformer", sat, True, None),
             ("coupled_inductors_2000", deck_file("coupled_inductors.cir"),
              True, 2000),
             ("trans_small", TRANS_SMALL, False, None),
             ("xfmr_mag", XFMR_MAG, False, None))
    err = 0.0
    for name, deck, trap, max_att in decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(
            deck, lambda cc, b: perturbed(cc, np.random.default_rng(4), b,
                                          ("R",)), lanes)
        plan, dev, src, st, sc, _ = lane_inputs(
            cc, cfg, params, state0,
            ts.SimOptions(integration="trap" if trap else "be"), "physics")
        if max_att:
            sc = sc._replace(max_attempts=max_att)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc)
        e = compare_run(name, k, p)
        err = max(err, e)
        if not max_att and not bool((k.t == cfg.tstop).all()):
            fail(f"{name}: a lane stopped before tstop")
        lay = plan.layout
        dmdh = k.state[:, lay["lm_dMdH"]:lay["lm_dMdH"] + plan.nlm]
        core = (f"committed dM/dH in [{float(dmdh.min()):.4g}, "
                f"{float(dmdh.max()):.4g}]" if plan.nlm else "no LM")
        phase("22 physics magnetic kernel vs plain", t0,
              f"{name} ({'trap' if trap else 'be'}): {lanes} lanes, "
              f"np1={plan.np1}, {plan.nlm} LM, {plan.nk} K, ks={plan.ks}, "
              f"accepted {int(k.accepted.sum())}, attempts "
              f"{int(k.attempts.sum())}, failed {int(k.fail.sum())} (the "
              f"plain version's too); counters equal, bit for bit, max abs "
              f"err {e:.3e}; "
              f"{core}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")

    # the store path: the linear OP, then one store launch
    t0 = time.perf_counter()
    opts = ts.SimOptions(integration="trap")
    cc, cfg, params, axes, state0 = setup(
        sat, lambda cc, b: perturbed(cc, np.random.default_rng(4), b,
                                     ("R",)), lanes)
    fn = ts.make_tran_batch(cc, cfg, axes, semantics="physics",
                            store="full", opts=opts)
    fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = fn(params, state0)
    torch.cuda.synchronize()
    got = counts()
    check_counts("physics magnetic store path", got,
                 {"stamped_solve": (1, 1), "run_kernel_store": (1, 1)})
    plan, dev, src, st, sc, _ = lane_inputs(cc, cfg, params, state0, opts,
                                            "physics")
    keep = run.Store(cfg.tstart, cfg.max_store)
    ks, kw, es, s_ms, w_ms, sp_ms = store_vs_plain(
        "saturating_transformer store", plan, dev, src, st, sc, keep)
    if not (torch.equal(kw.out_n, out.out_n)
            and torch.equal(kw.out_x, out.out_x)
            and torch.equal(ks.attempts, out.attempts)):
        fail("physics magnetic store path differs from a store launch on "
             "the same inputs")
    if bool(out.fail.any()) or not torch.equal(out.out_n, out.accepted):
        fail("physics magnetic store path: a lane failed or out_n is not "
             "the accepted count")
    store = dict(launches=got["run_kernel_store"], err=es, k_ms=s_ms,
                 p_ms=sp_ms, flops=run_bound(plan, ks, True),
                 nbytes=run_nbytes(plan, dev, src, st, None, lanes)
                 + nbytes(kw.out_x, kw.out_t))
    phase("22 physics magnetic store", t0,
          f"saturating_transformer (trap, store='full'): {lanes} lanes, "
          f"stamped-solve launches {got['stamped_solve']}, store launches "
          f"{got['run_kernel_store']}, rows {int(out.out_n.sum())}; the "
          f"store kernel against the plain store: counters and out_n equal, "
          f"max abs err {es:.3e}; launch {s_ms:.3f} ms, wrapper "
          f"{w_ms:.3f} ms, plain {sp_ms:.1f} ms on {smi}")
    del kw, out
    free()
    return err, store


def mag_newton_phase(lanes, smi):
    """Phase 23: LM and K with a diode (LM_DIODE) under compat and
    physics/trap: the transient path (the OP kernel with the windings'
    branch diagonal, then the Newton MAG instantiation), then the kernel
    against its plain version; the OP path (run_op_batch) and the DC sweep
    path (run_dc_batch), each then held to its plain version."""
    res = {}
    for semantics, trap in (("compat", False), ("physics", True)):
        opts = ts.SimOptions(integration="trap" if trap else "be")
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(LM_DIODE, rc_spread, lanes)
        fn = ts.make_tran_batch(cc, cfg, axes, semantics=semantics,
                                opts=opts)
        fn(params, state0)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = fn(params, state0)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"LM + diode {semantics} path", got,
                     {"op_kernel": (1, 1), "run_kernel": (1, 1)})
        if bool(out.fail.any()) or not bool((out.t_final == cfg.tstop).all()):
            fail(f"LM + diode {semantics}: a lane failed or stopped early")
        plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0,
                                                  opts, semantics)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
        e = compare_run(f"lm_diode {semantics}", k, p, check_jv=True)
        if not (torch.equal(out.attempts, k.attempts)
                and torch.equal(out.nr_iters, k.nr_iters)
                and torch.equal(out.t_final, k.t)):
            fail(f"LM + diode {semantics} path differs from a kernel run")
        res[f"run_{semantics}"] = dict(
            launches=got["run_kernel"], err=e, k_ms=k_ms, p_ms=p_ms,
            flops=run_bound(plan, k, semantics == "physics"),
            nbytes=run_nbytes(plan, dev, src, st, jv0, lanes))
        phase("23 magnetic Newton kernel vs plain", t0,
              f"lm_diode ({semantics}/{'trap' if trap else 'be'}): "
              f"{lanes} lanes, OP launches {got['op_kernel']}, run "
              f"launches {got['run_kernel']}, accepted "
              f"{int(k.accepted.sum())}, attempts {int(k.attempts.sum())}, "
              f"NR iterations {int(k.nr_iters.sum())}, failed 0; counters "
              f"equal, bit for bit, max abs err {e:.3e}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.1f} ms")

        # the OP path and the OP kernel on the magnetic deck against its
        # plain version
        t0 = time.perf_counter()
        reset_counts()
        opr = ts.run_op_batch(cc, params, axes, semantics=semantics)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"LM + diode {semantics} OP path", got,
                     {"op_kernel": (1, 1 << 30)})
        tk = TimedSolve(op.op_lanes)
        tp_ = TimedSolve(op.op_plain)
        ko = op.make_op_fused(cc, DEFAULTS, semantics, solve=tk)(params,
                                                                 state0)
        po = op.make_op_fused(cc, DEFAULTS, semantics, solve=tp_)(params,
                                                                  state0)
        for key in ("converged", "stage", "iters", "iters_all"):
            if not torch.equal(getattr(ko, key), getattr(po, key)):
                fail(f"LM + diode {semantics} OP: {key} differs")
        eo = exact_err("lm_diode OP", [("x", ko.x, po.x), ("x", opr.x, po.x)])
        if not bool(opr.converged.all()):
            fail(f"LM + diode {semantics} OP: a lane did not converge")
        plan_op = tk.args[0][0]
        per_lane = 8 * (plan_op.nd + op.dyn_width(plan_op)
                        + 2 * (plan_op.np1 + plan_op.kj)) + 8
        op_it = int(ko.iters_all.sum())
        res[f"op_{semantics}"] = dict(
            launches=got["op_kernel"], err=eo, k_ms=tk.ms(), p_ms=tp_.ms(),
            flops=int(op_it * (phys_newton_flops(plan_op)
                               if semantics == "physics"
                               else newton_flops(plan_op))
                      + lanes * (build_flops(plan_op,
                                             plan_op.entries[:plan_op.n_lin])
                                 + lu_flops(plan_op.np1))),
            nbytes=len(tk.events) * (lanes * per_lane + plan_op.topo.nbytes))
        phase("23 magnetic OP kernel vs plain", t0,
              f"lm_diode ({semantics}): {lanes} lanes, OP launches "
              f"{got['op_kernel']}, converged {int(opr.converged.sum())}, "
              f"NR iterations {op_it}; equal counts, bit for bit, max abs err "
              f"{eo:.3e}; "
              f"kernel {res[f'op_{semantics}']['k_ms']:.3f} ms, plain "
              f"{res[f'op_{semantics}']['p_ms']:.1f} ms")

        # the DC sweep path of the primary's source
        t0 = time.perf_counter()
        pts = np.linspace(-2.0, 5.0, 15)
        reset_counts()
        xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts,
                                   semantics=semantics)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"LM + diode {semantics} DC path", got,
                     {"dc_sweep_kernel": (1, 1)})
        if not bool(conv.all()) or not bool(torch.isfinite(xs).all()):
            fail(f"LM + diode {semantics} DC: a point not converged")
        tk = TimedSolve(dc.dc_lanes)
        tp_ = TimedSolve(dc.dc_plain)
        kd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=tk)(
            params, state0, pts)
        pd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=tp_)(
            params, state0, pts)
        for key in ("conv", "iters"):
            if not torch.equal(getattr(kd, key), getattr(pd, key)):
                fail(f"LM + diode {semantics} DC: {key} differs")
        ed = exact_err("lm_diode DC", [
            ("xs", kd.xs.reshape(-1, cc.np1), pd.xs.reshape(-1, cc.np1)),
            ("xs", xs.reshape(-1, cc.np1), pd.xs.reshape(-1, cc.np1))])
        plan_dc, dev_, dyn_, vs_, _ = tk.args[0]
        dc_it = int(kd.iters.sum())
        per_it = (phys_newton_flops(plan_dc) if semantics == "physics"
                  else newton_flops(plan_dc)) - (plan_dc.np1 - 1)
        res[f"dc_{semantics}"] = dict(
            launches=got["dc_sweep_kernel"], err=ed, k_ms=tk.ms(),
            p_ms=tp_.ms(), flops=int(dc_it * per_it),
            nbytes=nbytes(dev_, dyn_, vs_, kd.xs) + plan_dc.topo.nbytes
            + lanes * len(pts) * 8)
        phase("23 magnetic DC sweep kernel vs plain", t0,
              f"lm_diode ({semantics}): {lanes} lanes x {len(pts)} points "
              f"in one launch, all converged, Newton iterations {dc_it}; "
              f"equal counts, bit for bit, max abs err {ed:.3e}; kernel "
              f"{res[f'dc_{semantics}']['k_ms']:.3f} ms, plain "
              f"{res[f'dc_{semantics}']['p_ms']:.1f} ms on {smi}")
    return res


def mag_ac_phase(lanes):
    """Phase 24: AC of saturating_transformer.cir with its primary driven
    by a unit AC source: the linear OP's bias (one stamped solve), then one
    AC launch whose host-assembled systems carry each winding's -ωL and
    the coupling's -ωM; then the AC kernel against its plain version."""
    deck = deck_file("saturating_transformer.cir").replace("SIN(0 20 1k)",
                                                           "AC 1 0")
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(
        deck, lambda cc, b: perturbed(cc, np.random.default_rng(0), b,
                                      ("R",)), lanes)
    freqs = ts.frequency_points("DEC", 10.0, 1e5, 9)
    ts.run_ac_batch(cc, params, axes, freqs)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs)
    torch.cuda.synchronize()
    got = counts()
    check_counts("magnetic AC path", got, {"stamped_solve": (1, 1),
                                           "ac_kernel": (1, 1)})
    sec = int(cc.idx["LM"]["branch"][1])
    if not bool(torch.isfinite(xr).all() & torch.isfinite(xi).all()) or \
            float(xr[..., sec].abs().max()) <= 1e-4:
        fail("magnetic AC: a value not finite or no secondary current")
    tk = TimedSolve(ac.launch_ac_kernel)
    tp_ = TimedSolve(ac.ac_plain)
    kr, ki, _ = make_ac_batch(cc, axes, DEFAULTS, ac_solve=tk)(
        params, state0, freqs)
    pr, pi_, _ = make_ac_batch(cc, axes, DEFAULTS, ac_solve=tp_)(
        params, state0, freqs)
    err = max_err("magnetic AC", [
        ("xr", kr.reshape(-1, cc.np1), pr.reshape(-1, cc.np1)),
        ("xi", ki.reshape(-1, cc.np1), pi_.reshape(-1, cc.np1)),
        ("xr", xr.reshape(-1, cc.np1), pr.reshape(-1, cc.np1))])
    n2 = 2 * cc.np1
    m = ac.build_systems(*tk.args[0])
    a_, b_ = m[:, :, :n2].contiguous(), m[:, :, n2:].contiguous()
    torch.linalg.solve(a_, b_)  # warm-up
    _, lib_ms = timed_call(torch.linalg.solve, a_, b_)
    phase("24 magnetic AC", t0,
          f"saturating_transformer (AC source): {lanes} lanes x "
          f"{len(freqs)} frequencies, stamped-solve launches "
          f"{got['stamped_solve']}, AC kernel launches {got['ac_kernel']}; "
          f"kernel vs plain max abs err {err:.3e}; kernel {tk.ms():.3f} ms, "
          f"plain {tp_.ms():.1f} ms, torch.linalg.solve {lib_ms:.3f} ms on "
          f"the same systems")
    return err


def mag_main_phase(lanes, smi):
    """Phase 25: the main path saturating_transformer_8192_physics_trap:
    make_tran_batch(semantics='physics', SimOptions(integration='trap')),
    store='none', non-UIC: one stamped-solve launch for the linear OP (the
    windings' +1e-3 branch diagonal, no K), the bias-point seed of each
    winding's current, one launch of the PHYS MAG run kernel; no lane
    failed; then the linear OP's stamped solve and the run kernel on the
    same inputs against their plain versions."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("saturating_transformer.cir"),
        lambda cc, b: perturbed(cc, np.random.default_rng(0), b, ("R",)),
        lanes)
    opts = ts.SimOptions(integration="trap")
    fn = ts.make_tran_batch(cc, cfg, axes, semantics="physics", opts=opts)
    if fn.engine != "run":
        fail(f"physics magnetic main path engine {fn.engine!r}")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("physics magnetic main path", got,
                 {"stamped_solve": (1, 1), "run_kernel": (1, 1)})
    accepted = int(out.accepted.sum())
    att = out.attempts
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"physics magnetic main path: {failed} of {lanes} lanes "
             "failed or stopped early")
    lm = out.state["LM"]
    for leaf in lm.values():
        if leaf.shape != (lanes, 2) or not bool(torch.isfinite(leaf).all()):
            fail("physics magnetic main path: an LM leaf is not finite or "
                 "has the wrong shape")
    if not bool((lm["M"] != 0).all()):
        fail("physics magnetic main path: a core never moved")
    # the two windings share one core: their core copies stay equal
    if not all(torch.equal(lm[key][:, 0], lm[key][:, 1])
               for key in ("H", "M", "Mirr", "dMdH")):
        fail("physics magnetic main path: the windings' cores differ")
    tk = TimedSolve(solve_stamped.solve_lanes, stamped_systems)
    tp_ = TimedSolve(solve_stamped.solve_plain)
    ok_ = make_op(cc, opts, "physics", solve=tk)(params, state0)
    op_ = make_op(cc, opts, "physics", solve=tp_)(params, state0)
    op_err = max_err("main path linear OP", [("x", ok_.x, op_.x)])
    if not bool(ok_.converged.all()):
        fail("physics magnetic main path: the linear OP did not converge")
    plan, dev, src, st, sc, _ = lane_inputs(cc, cfg, params, state0, opts,
                                            "physics")
    k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc)
    err = compare_run("saturating_transformer_8192_physics_trap", k, p)
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.t_final, k.t)):
        fail("physics magnetic main path differs from a kernel run on the "
             "same inputs")
    phase("25 physics magnetic main path", t0,
          f"saturating_transformer_8192_physics_trap: engine={fn.engine}, "
          f"stamped-solve launches={got['stamped_solve']}, run kernel "
          f"launches={got['run_kernel']}, lanes={lanes}, accepted="
          f"{accepted}, attempts={int(att.sum())} (per lane "
          f"{int(att.min())}..{int(att.max())}), failed={failed}, every "
          f"lane at tstop, wall={wall:.6f} s, {accepted / wall:.6e} "
          f"accepted steps/s on {smi}; the linear OP's stamped solve vs "
          f"plain max abs err {op_err:.3e} ({tk.ms():.3f} ms, plain "
          f"{tp_.ms():.1f} ms, torch.linalg.solve on the built systems "
          f"{tk.ms(lib=True):.3f} ms); the run kernel on the same inputs "
          f"against "
          f"its plain version: counters equal, bit for bit, max abs err "
          f"{err:.3e}; "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
    return dict(launches=got["run_kernel"], err=err, k_ms=k_ms, p_ms=p_ms,
                plan=plan, accepted=accepted, attempts=int(att.sum()),
                flops=run_bound(plan, k, True),
                nbytes=run_nbytes(plan, dev, src, st, None, lanes))


def physics_store_phase(lanes, smi):
    """Phase 26: the physics store at the main path's size:
    make_tran_batch(semantics='physics', store='full') on the 8192 lanes
    of phase 21 (the rectifier under trap): one launch of the OP kernel's
    physics flavour, one launch of the PHYS store instantiation; then that
    store kernel against the plain store on the same lanes, timed alone
    into zeroed buffers and through its wrapper."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("half_wave_rectifier.cir"), rc_spread, lanes)
    opts = ts.SimOptions(integration="trap")
    fn = ts.make_tran_batch(cc, cfg, axes, semantics="physics",
                            store="full", opts=opts)
    out = fn(params, state0)  # warm-up
    del out
    free()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("physics store path", got, {"op_kernel": (1, 1),
                                             "run_kernel_store": (1, 1)})
    if not torch.equal(out.out_n, out.accepted) or bool(
            out.store_overflow.any()) or bool(out.fail.any()):
        fail("physics store path: out_n is not the accepted count, a row "
             "overflowed, or a lane failed")
    rows = int(out.out_n.sum())
    del out
    free()
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0, opts,
                                              "physics")
    keep = run.Store(cfg.tstart, cfg.max_store)
    k, kw, e, k_ms, w_ms, p_ms = store_vs_plain(
        "half_wave_rectifier_physics_full", plan, dev, src, st, sc, keep,
        jv0)
    flops = (int(k.attempts.sum()) * phys_step_flops(plan)
             + int(k.nr_iters.sum()) * phys_newton_flops(plan))
    nbytes_ = (run_nbytes(plan, dev, src, st, jv0, lanes)
               + nbytes(kw.out_x, kw.out_t, kw.out_n, kw.overflow))
    phase("26 physics store main path", t0,
          f"half_wave_rectifier (physics/trap, store='full'): {lanes} "
          f"lanes, OP kernel launches {got['op_kernel']}, store launches "
          f"{got['run_kernel_store']}, stored rows {rows}, wall={wall:.6f} "
          f"s, {rows / wall:.6e} stored rows/s on {smi}; the store kernel "
          f"against the plain store on the same lanes: counters and out_n "
          f"equal, bit for bit, max abs err {e:.3e}; kernel {k_ms:.3f} ms "
          f"(the launch into zeroed buffers), {w_ms:.3f} ms (the wrapper), "
          f"plain {p_ms:.1f} ms")
    del kw
    free()
    return dict(launches=got["run_kernel_store"], err=e, k_ms=k_ms,
                w_ms=w_ms, p_ms=p_ms, flops=int(flops), nbytes=nbytes_)


# ------------------------------------------------------ general engine
# Decks past the kernels' caps through the general engine (engine/tran,
# op, dc, ac): its Newton is a host loop over the stamped solve, whose
# block instantiation takes np1 past 32; its dense solves are the GJ
# kernel (csrc/gj_kernel.cu).


def cockcroft_walton(stages, tstop="2m"):
    """A half-wave Cockcroft-Walton multiplier of ``stages`` stages
    (tests/test_torch_general.py): 2·stages diodes and capacitors, np1 =
    2·stages + 3, a 100 V 1 kHz sine into a 10 MΩ load."""
    lines = [f"* {stages}-stage half-wave Cockcroft-Walton multiplier",
             f".tran 5u {tstop}", "Vin a 0 SIN(0 100 1k)",
             "C1 a p1 100n", "D1 0 p1 DMOD", "D2 p1 s1 DMOD",
             "C2 0 s1 100n"]
    for k in range(2, stages + 1):
        lines += [f"C{2 * k - 1} p{k - 1} p{k} 100n",
                  f"D{2 * k - 1} s{k - 1} p{k} DMOD",
                  f"D{2 * k} p{k} s{k} DMOD",
                  f"C{2 * k} s{k - 1} s{k} 100n"]
    lines += [f"Rload s{stages} 0 10meg",
              ".model DMOD D (Is=1e-14 N=1.0 Cj0=2p Tt=5n)", ""]
    return "\n".join(lines)


def rc_ladder(stages):
    """An RC ladder of ``stages`` stages (np1 = stages + 3) driven by a 1
    kHz sine, to 0.05 ms."""
    lines = [f"* {stages}-stage rc ladder", ".tran 0.01m 0.05m",
             "Vin 1 0 SIN(0 1 1k)"]
    for k in range(1, stages + 1):
        lines += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 1n"]
    return "\n".join(lines) + "\n"


def lc_ladder(sections):
    """A doubly terminated 50 Ω LC low-pass of ``sections`` sections
    (tests/test_torch_general_analyses.py): np1 = 2·sections + 4 (an
    inductor's branch row a section), 21 frequencies from 10 kHz to 100
    MHz."""
    lines = [f"* {sections}-section 50 ohm LC ladder low-pass",
             ".ac dec 21 10k 100meg", "Vin in 0 AC 1 0", "Rs in n0 50"]
    for k in range(1, sections + 1):
        lines += [f"L{k} n{k - 1} n{k} 1u", f"C{k} n{k} 0 400p"]
    lines += [f"Rl n{sections} 0 50", ""]
    return "\n".join(lines)


def c_spread(cc, b):
    """C spread log-normally by 0.1, numpy default_rng(0)."""
    return perturbed(cc, np.random.default_rng(0), b, ("C",))


def dense_sets(n, b, seed):
    """b random well-conditioned (n, n) systems on the card with row 0 the
    ground identity (x[0] = 0), a structural zero on diagonal 3 (pivoting
    needed), an all-zero row 2 on lane 5 (singular) and a NaN column 4 on
    lane 6 (rows 2 and 4 the last one where n is smaller); from n = 8 a NaN
    in column n - 2 of row 2 on lane 8 (the block leaves the column loop
    late), and from n = 18 the cross-warp tie on lanes 7 and 9-40:
    integer entries, and column 1's largest |a| twice, +10 in row 2 and
    -10 in row 17 (warps 2 and 1 of csrc/gj_block.cuh's gj_wide; the pivot
    rule takes row 2, and the lowest row in the later columns' ties)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)) + 4.0 * np.eye(n)
    rhs = rng.normal(size=(b, n))
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    rhs[:, 0] = 0.0
    if n > 3:
        a[:, 3, 3] = 0.0
    a[5, min(2, n - 1), :] = 0.0
    a[6, :, min(4, n - 1)] = np.nan
    if n >= 8:
        a[8, 2, n - 2] = np.nan
    if n >= 18:
        tie = [7] + list(range(9, 41))
        a[tie, 1:, :] = np.round(2.0 * a[tie, 1:, :])
        a[tie, 1:, 1] = np.clip(a[tie, 1:, 1], -3.0, 3.0)
        a[tie, 2, 1], a[tie, 17, 1] = 10.0, -10.0
    return (torch.as_tensor(a, device=DEVICE),
            torch.as_tensor(rhs, device=DEVICE))


def bad_lanes(n, b):
    """dense_sets' non-finite lanes."""
    return [i in (5, 6) or (i == 8 and n >= 8) for i in range(b)]


def dense_pattern(n):
    """A stamped pattern with one entry per cell of rows 1..n-1 and one RHS
    entry per row: the stamped solve of (a[:, 1:], b[:, 1:]) with gmin 0
    builds [a | b] itself (row 0 the ground identity)."""
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    return solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                           np.arange(1, n))


def same_bits(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0, posinf=8.0,
                                        neginf=9.0),
                       torch.nan_to_num(b, nan=7.0, posinf=8.0, neginf=9.0))


# n of phase 27: the GJ kernel's bucket edges (csrc/gj_block.cuh:
# gj_bucket, a row a thread in registers to 96; gj_wide_bucket, the
# registers of a 512-thread block, buckets 127 and 144; the shared-memory
# body to NBIG = 168, the device-memory body above) and the stamped
# solve's (a warp segment of 4, 8, 16 or 32 lanes a lane to 32, a warp to
# 64, a block above)
GJ_SIZES = (1, 2, 4, 5, 6, 8, 9, 16, 17, 32, 33, 40, 48, 49, 64, 65, 72,
            73, 96, 97, 127, 128, 129, 130, 144, 145, 168, 169, 200)
# phase 27's timed sizes: 8192 random systems each, the kernel beside
# torch.linalg.solve
GJ_TIMED = (128, 132)
# its lanes: no multiple of 32 (256 hid a warp writing into its
# neighbour's system)
GJ_LANES = 259


def gj_plain_sets(lanes):
    """Phase 27's sets and their plain versions' x, made while the kernels
    build (none needs a library): for each n in GJ_SIZES, dense_sets'
    systems, gj_plain's x and, past n = 1, the stamped pattern, its inputs
    and solve_plain's x; with the seconds they took."""
    t0 = time.perf_counter()
    sets = []
    for n in GJ_SIZES:
        a, rhs = dense_sets(n, lanes, n)
        stamped = None
        if n > 1:
            fn = dense_pattern(n)
            g = torch.zeros(lanes, dtype=torch.float64, device=DEVICE)
            vals = a[:, 1:, :].reshape(lanes, -1).contiguous()
            rv = rhs[:, 1:].contiguous()
            stamped = (fn, vals, rv, g, solve_stamped.solve_plain(
                fn.pattern, vals, rv, g))
        sets.append((n, a, rhs, solve.gj_plain(a, rhs), stamped))
    torch.cuda.synchronize()
    return sets, time.perf_counter() - t0


def gj_phase(lanes, plain_sets):
    """Phase 27: the GJ kernel against gj_plain on random sets of every n
    in GJ_SIZES, with a zero-diagonal column, a singular lane, a NaN lane,
    a late NaN and a cross-warp tie (dense_sets; ``plain_sets`` from
    gj_plain_sets): the same bits and the same non-finite lanes; on the
    same systems (n > 1: row 0 is the ground row the stamped build makes)
    the stamped solve (a warp segment a system to n = 32, a warp to 64, a
    block above: a row a thread to 96, 16 warps' registers to 144, shared
    memory to 168, device memory above) and its plain version.  Then the
    GJ kernel and torch.linalg.solve timed on 8192 random systems of each
    n in GJ_TIMED (the faster of two calls each), the kernel's first 512
    held to gj_plain."""
    sets, plain_s = plain_sets
    t0 = time.perf_counter() - plain_s  # the plain versions' seconds too
    err = 0.0
    notes = []
    for n, a, rhs, xp, stamped in sets:
        outs = [("GJ kernel", solve.launch_gj(a, rhs))]
        if stamped is not None:
            fn, vals, rv, g, sp = stamped
            outs += [("stamped kernel", fn(vals, rv, g)),
                     ("stamped plain", sp)]
        torch.cuda.synchronize()
        bad = ~torch.isfinite(xp).all(dim=1)
        if bad.tolist() != bad_lanes(n, lanes):
            fail(f"GJ n={n}: the singular and the NaN lanes are not the "
                 "only non-finite ones")
        for what, got in outs:
            if not torch.equal(~torch.isfinite(got).all(dim=1), bad):
                fail(f"GJ n={n}: the {what}'s non-finite lanes differ")
            err = max(err, check_err(f"GJ n={n}", what, got[~bad],
                                     xp[~bad], err_scale(xp[~bad])))
        bits = [same_bits(got, xp) for _, got in outs]
        notes.append(f"n={n} ({solve.body(n)}): bit-identical "
                     f"{'/'.join(map(str, bits))}")
        if not all(bits):
            fail(f"GJ n={n}: not bit-identical ("
                 f"{', '.join(w for w, _ in outs)} vs gj_plain: {bits})")
    del sets
    timed = []
    for n in GJ_TIMED:
        gen = torch.Generator(device=DEVICE).manual_seed(n)
        a = torch.randn((BENCH_LANES, n, n), generator=gen,
                        dtype=torch.float64, device=DEVICE) + 4.0 * torch.eye(
                            n, dtype=torch.float64, device=DEVICE)
        rhs = torch.randn((BENCH_LANES, n), generator=gen,
                          dtype=torch.float64, device=DEVICE)
        xk = solve.launch_gj(a, rhs)  # warm-up
        if not same_bits(xk[:512], solve.gj_plain(a[:512], rhs[:512])):
            fail(f"GJ n={n}, 8192 systems: not bit-identical to gj_plain")
        k_ms = min(timed_call(solve.launch_gj, a, rhs)[1] for _ in range(2))
        torch.linalg.solve(a[:64], rhs[:64])  # warm-up
        lib_ms = min(timed_call(torch.linalg.solve, a, rhs)[1]
                     for _ in range(2))
        timed.append(f"n={n} ({solve.body(n)}), {BENCH_LANES} random "
                     f"systems: GJ kernel {k_ms:.3f} ms, torch.linalg.solve "
                     f"{lib_ms:.3f} ms")
        del a, rhs, xk
        free()
    phase("27 GJ kernel vs plain", t0,
          f"{lanes} random systems each, a zero diagonal, a singular lane, "
          f"a NaN lane, a late NaN and a cross-warp tie: GJ kernel "
          f"(registers to 96, 16 warps' registers to 144, shared memory to "
          f"168, device memory above), stamped kernel (a warp segment to "
          f"32, a warp to 64, a block above, the same bodies past 64) "
          f"and stamped plain against gj_plain, the same non-finite lanes, "
          f"max abs err {err:.3e}; " + "; ".join(notes) + "; "
          + "; ".join(timed))
    return err


def general_vs_run_phase(lanes):
    """Phase 28: the general engine against the run kernel on an eligible
    deck: the half-wave rectifier, 256 lanes, R and C spread, through
    engine/tran.make_tran (the general OP, then the general Newton over
    the stamped solve) and through make_tran_batch (the OP and run
    kernels): counters equal per lane, state and jv within rtol 1e-9."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("half_wave_rectifier.cir"), rc_spread, lanes)
    fk = ts.make_tran_batch(cc, cfg, axes)
    if fk.engine != "run":
        fail(f"general vs run: engine {fk.engine!r}, expected 'run'")
    k = fk(params, state0)
    reset_counts()
    g = make_tran(cc, cfg, store="none")(params, state0)
    torch.cuda.synchronize()
    got = counts()
    check_counts("general vs run", got, {"gj_kernel": (1, 2),
                                         "stamped_solve": (1, 1 << 30)})
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        if not torch.equal(getattr(k, key), getattr(g, key)):
            bad = int((getattr(k, key) != getattr(g, key)).sum())
            fail(f"general vs run: {key} differs on {bad} lanes")
    pairs = [("t_final", g.t_final, k.t_final)] + [
        (f"{what}.{kd}.{key}", gt[kd][key], kt[kd][key])
        for what, gt, kt in (("state", g.state, k.state),
                             ("jv", g.jv, k.jv))
        for kd in kt for key in kt[kd]]
    err = max_err("general vs run", pairs)
    phase("28 general engine vs run kernel", t0,
          f"half_wave_rectifier: {lanes} lanes, attempts "
          f"{int(g.attempts.sum())}, NR iterations {int(g.nr_iters.sum())}, "
          f"GJ launches {got['gj_kernel']}, stamped-solve launches "
          f"{got['stamped_solve']}: counters equal to the run kernel's, "
          f"max abs err {err:.3e}")
    return err


def stamped_systems(pat, vals, rvals, gmin):
    m = solve_stamped.build_plain(pat, vals, rvals, gmin)
    return m[:, :, :pat.n].contiguous(), m[:, :, pat.n:].contiguous()


def cw16_phase(lanes, smi, cut_lanes=GJ_LANES):
    """Phase 29: the main path cw16_8192: a 16-stage Cockcroft-Walton
    multiplier (np1 = 35, 32 diodes: the kernels' 64-row bucket, a lane's
    system on a whole warp), C spread 0.1, compat, store='none', not UIC,
    through make_tran_batch to 2 ms: engine "run", one OP launch and one
    run launch, no stamped or GJ launch; no lane failed, every lane at
    tstop, every capacitor voltage finite and under 3200 V.  The run
    launch alone on the main path's inputs, then the run kernel against
    run_plain bit for bit on the same lanes over the run's first 0.1 ms
    and on ``cut_lanes`` lanes over the whole run; the OP kernel against
    op_plain on the main path's lanes.  Then, under TOYSPICE_TRAN=general,
    make_tran_batch's general engine over the first 0.1 ms: counters equal
    to the run kernel's over that cut, state and jv within rtol 1e-9; and
    the general engine with the stamped and GJ kernels against it with
    their plain versions on the same lanes (counters equal, state and jv
    bit for bit), the kernels' times and torch.linalg.solve's being those
    launches'."""
    t0 = time.perf_counter()
    deck = cockcroft_walton(16)
    cc, cfg, params, axes, state0 = setup(deck, c_spread, lanes)
    if cc.np1 != 35 or cc.kind_count("D") != 32:
        fail("cw16: np1 is not 35 or the diodes are not 32")
    short = cfg._replace(tstop=1e-4)
    kr = ts.make_tran_batch(cc, short, axes)(params, state0)  # warm-up
    fn = ts.make_tran_batch(cc, cfg, axes)
    if fn.engine != "run":
        fail(f"cw16 engine {fn.engine!r} ({fn.engine_reason})")
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("cw16 main path", got, {"op_kernel": (1, 1),
                                         "run_kernel": (1, 1)})
    accepted = int(out.accepted.sum())
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"cw16 main path: {failed} of {lanes} lanes failed or stopped "
             "early")
    vc = out.state["C"]["v0"]
    if not bool(torch.isfinite(vc).all()) or not bool(
            (vc.abs() < 3200.0).all()):
        fail("cw16 main path: a capacitor voltage is not finite or exceeds "
             "16 stages of 200 V")
    nri = out.nr_iters
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
    shape = run.segment_shape(plan, lanes)
    k, main_ms = timed_call(run.launch_run_kernel, plan, dev, src, st, sc,
                            jv0)
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.nr_iters, k.nr_iters)
            and torch.equal(out.t_final, k.t)
            and torch.equal(out.jv["D"]["vd"], k.jv)):
        fail("cw16 main path differs from a run-kernel launch on its "
             "inputs")
    main_flops = run_bound(plan, k, False)
    main_bytes = run_nbytes(plan, dev, src, st, jv0, lanes)
    del k
    # the run kernel against its plain version: these lanes over the first
    # 0.1 ms, cut_lanes lanes over the whole run
    sc_short = sc._replace(tstop=short.tstop)
    kc, kc_ms, pc, pc_ms = kernel_vs_plain(plan, dev, src, st, sc_short, jv0)
    err = compare_run("cw16 run kernel, first 0.1 ms", kc, pc, check_jv=True)
    cut = [x[:cut_lanes] for x in (dev, src, st, jv0)]
    kw_ = run.launch_run_kernel(plan, cut[0], cut[1], cut[2], sc, cut[3])
    pw_, pw_ms = plain_timed(plan, *cut[:3], sc, cut[3])
    err = max(err, compare_run("cw16 run kernel, whole run", kw_, pw_,
                               check_jv=True))
    run_wide = dict(launches=got["run_kernel"], err=err, k_ms=kc_ms,
                    p_ms=pc_ms, flops=run_bound(plan, kc, False),
                    nbytes=run_nbytes(plan, dev, src, st, jv0, lanes))
    del pc, kw_, pw_
    # the OP kernel against its plain version on the main path's lanes
    tk, tp_ = TimedSolve(op.op_lanes), TimedSolve(op.op_plain)
    ko = op.make_op_fused(cc, DEFAULTS, solve=tk)(params, state0)
    po = op.make_op_fused(cc, DEFAULTS, solve=tp_)(params, state0)
    for key in ("converged", "stage", "iters", "iters_all"):
        if not torch.equal(getattr(ko, key), getattr(po, key)):
            fail(f"cw16 OP: {key} differs between the kernel and op_plain")
    if not bool(ko.converged.all()):
        fail("cw16 OP: a lane did not converge")
    plan_op = tk.args[0][0]
    op_wide = dict(
        launches=got["op_kernel"],
        err=exact_err("cw16 OP", [("x", ko.x, po.x)] + [
            (f"jv.{kd}.{key}", ko.jv[kd][key], po.jv[kd][key])
            for kd in po.jv for key in po.jv[kd]]),
        k_ms=tk.ms(), p_ms=tp_.ms(),
        flops=int(ko.iters_all.sum()) * newton_flops(plan_op) + lanes * (
            build_flops(plan_op, plan_op.entries[:plan_op.n_lin])
            + lu_flops(plan_op.np1)),
        nbytes=len(tk.events) * (lanes * (8 * (
            plan_op.nd + op.dyn_width(plan_op)
            + 2 * (plan_op.np1 + plan_op.kj)) + 8) + plan_op.topo.nbytes))
    del ko, po, tk, tp_
    phase("29 cw16_8192 main path", t0,
          f"cw16 (np1={cc.np1}, {cc.kind_count('D')} diodes): engine="
          f"{fn.engine} ({fn.engine_reason}), OP kernel launches="
          f"{got['op_kernel']}, run kernel launches={got['run_kernel']}, "
          f"stamped-solve launches={got['stamped_solve']}, GJ kernel "
          f"launches={got['gj_kernel']}; launch shape (the library's): "
          f"segments of W={shape[0]} threads, {shape[1]} lanes a block, "
          f"{shape[2]} blocks of {shape[3]} threads, {shape[4]} B of shared "
          f"memory a block; lanes={lanes}, accepted={accepted}, attempts="
          f"{int(out.attempts.sum())}, failed={failed}, every lane at "
          f"tstop, Newton iterations per lane {int(nri.min())}.."
          f"{int(nri.max())} (mean {float(nri.double().mean()):.3f}), wall="
          f"{wall:.6f} s, {accepted / wall:.6e} accepted steps/s on {smi}; "
          f"the run launch alone on its inputs {main_ms:.3f} ms; the run "
          f"kernel vs run_plain on these lanes over the first 0.1 ms "
          f"(kernel {kc_ms:.3f} ms, plain {pc_ms:.1f} ms) and on "
          f"{cut_lanes} lanes over the whole run (plain {pw_ms:.1f} ms): "
          f"counters equal, bit for bit, max abs err {err:.3e}; the OP "
          f"kernel vs op_plain: bit for bit, kernel {op_wide['k_ms']:.3f} "
          f"ms, plain {op_wide['p_ms']:.1f} ms")

    # the general engine over the first 0.1 ms, chosen by its override
    t0 = time.perf_counter()
    os.environ["TOYSPICE_TRAN"] = "general"
    try:
        fg = ts.make_tran_batch(cc, short, axes)
    finally:
        del os.environ["TOYSPICE_TRAN"]
    if fg.engine != "general":
        fail(f"cw16 under TOYSPICE_TRAN=general: engine {fg.engine!r}")
    reset_counts()
    g = fg(params, state0)
    torch.cuda.synchronize()
    gc_ = counts()
    check_counts("cw16 general engine", gc_, {"gj_kernel": (1, 2),
                                              "stamped_solve": (1, 1 << 30)})
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        if not torch.equal(getattr(kr, key), getattr(g, key)):
            fail(f"cw16 general engine vs run kernel: {key} differs")
    gen_err = max_err("cw16 general engine vs run kernel", [
        ("t_final", g.t_final, kr.t_final)] + [
        (f"{what}.{kd}.{key}", gt[kd][key], kt[kd][key])
        for what, gt, kt in (("state", g.state, kr.state),
                             ("jv", g.jv, kr.jv))
        for kd in kt for key in kt[kd]])
    del g, kr
    # its kernels against their plain versions on the same lanes
    tk, gk = (TimedSolve(solve_stamped.solve_lanes, stamped_systems),
              TimedSolve(solve.linear_solve))
    tp_, gp = TimedSolve(solve_stamped.solve_plain), TimedSolve(solve.gj_plain)
    k = make_tran(cc, short, store="none", solve=tk, dense_solve=gk)(
        params, state0)
    p = make_tran(cc, short, store="none", solve=tp_, dense_solve=gp)(
        params, state0)
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        if not torch.equal(getattr(k, key), getattr(p, key)):
            fail(f"cw16: {key} differs between the kernels and the plain "
                 "versions")
    pairs = [(f"{what}.{kd}.{key}", kt[kd][key], pt[kd][key])
             for what, kt, pt in (("state", k.state, p.state),
                                  ("jv", k.jv, p.jv))
             for kd in pt for key in pt[kd]]
    err = max_err("cw16 kernels vs plain", pairs)
    if not all(same_bits(a, b) for _, a, b in pairs):
        fail("cw16: the kernels' state or jv is not bit-identical to the "
             "plain versions'")
    pat, vals, rvals, gmin = tk.args[0]
    ga, gb = gk.args[0]
    calls = len(tk.args)
    per_launch_bytes = (nbytes(vals, rvals, gmin) + pat.table.nbytes
                        + lanes * pat.n * 8)
    stamped_big = dict(
        launches=gc_["stamped_solve"], err=err, k_ms=tk.ms(),
        p_ms=tp_.ms(), lib_ms=tk.ms(lib=True), calls=calls,
        flops=calls * lanes * stamped_flops(pat),
        nbytes=calls * per_launch_bytes, n=pat.n, terms=int(pat.table[0]))
    gj_seed = dict(launches=gc_["gj_kernel"], k_ms=gk.ms(), p_ms=gp.ms(),
                   systems=ga.shape[0], n=ga.shape[1],
                   flops=len(gk.args) * ga.shape[0] * lu_flops(ga.shape[1]),
                   nbytes=len(gk.args) * (nbytes(ga, gb) + nbytes(gb)))
    gl0 = torch.cuda.Event(enable_timing=True)
    gl1 = torch.cuda.Event(enable_timing=True)
    gl0.record()
    torch.linalg.solve(ga, gb)
    gl1.record()
    torch.cuda.synchronize()
    gj_seed["lib_ms"] = len(gk.args) * gl0.elapsed_time(gl1)
    phase("29 cw16_8192 general engine", t0,
          f"cw16 under TOYSPICE_TRAN=general, the first 0.1 ms: engine="
          f"{fg.engine} ({fg.engine_reason}), GJ kernel launches="
          f"{gc_['gj_kernel']}, stamped-solve launches="
          f"{gc_['stamped_solve']} (warp instantiation, n={pat.n}, "
          f"{int(pat.table[0])} terms), no run or OP kernel launch; "
          f"counters equal to the run kernel's over that cut, max abs err "
          f"{gen_err:.3e}; the kernels vs their plain versions on these "
          f"lanes ({calls} stamped launches): counters equal, "
          f"bit-identical, max abs err {err:.3e}; stamped kernel "
          f"{stamped_big['k_ms']:.3f} ms ({stamped_big['k_ms'] / calls:.4f} "
          f"ms a launch), plain {stamped_big['p_ms']:.1f} ms, "
          f"torch.linalg.solve on "
          f"the built systems {stamped_big['lib_ms']:.3f} ms; GJ seed "
          f"kernel {gj_seed['k_ms']:.3f} ms, plain {gj_seed['p_ms']:.3f} ms")
    del k, p, tk, gk, tp_, gp
    free()
    return (stamped_big, gj_seed, run_wide, op_wide,
            dict(wall=wall, accepted=accepted, main_ms=main_ms,
                 flops=main_flops, nbytes=main_bytes))


@contextlib.contextmanager
def override(name, value):
    """An engine override (engine/overrides.py) set for the block alone."""
    os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)


def ac_freqs(cc):
    a = cc.netlist.ac
    return ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)


def ac_vs_plain(name, cc, params, axes, state0, freqs, main,
                semantics="compat", chunk=None):
    """The AC kernel against ac_plain on the inputs of the deck's fused AC
    (make_ac_batch with a timed launch, counts not read; the kernel's time
    the fastest of that launch and two more on its inputs): the kernel's x
    and the main path's (xr, xi) bit for bit against ac_plain on the same
    G, B^ and RHS, ``chunk`` instances at a time; torch.linalg.solve on
    the same systems (build_systems) in the same chunks, as the library
    yardstick.  Returns the figures for the bounds and the kernels line."""
    tk = TimedSolve(ac.launch_ac_kernel)
    kr, ki, _ = make_ac_batch(cc, axes, DEFAULTS, semantics, ac_solve=tk)(
        params, state0, freqs)
    g, bh, r, om = tk.args[0]
    k_ms = min([tk.ms()] + [timed_call(ac.launch_ac_kernel, g, bh, r, om)[1]
                            for _ in range(2)])
    b, np1 = g.shape[0], g.shape[1]
    n2, chunk = 2 * np1, chunk or g.shape[0]
    xr, xi = main
    p_ms = lib_ms = err = 0.0
    bits = True
    for i in range(0, b, chunk):
        sl = slice(i, i + chunk)
        xp, ms = timed_call(ac.ac_plain, g[sl], bh[sl], r[sl], om)
        p_ms += ms
        pairs = [("xr", kr[sl], xp[..., :np1]), ("xi", ki[sl], xp[..., np1:]),
                 ("main xr", xr[sl], xp[..., :np1]),
                 ("main xi", xi[sl], xp[..., np1:])]
        err = max(err, max_err(name, pairs))
        bits = bits and all(same_bits(a, b_) for _, a, b_ in pairs)
        del xp, pairs
        m = ac.build_systems(g[sl], bh[sl], r[sl], om)
        a_, b_ = m[:, :, :n2].contiguous(), m[:, :, n2:].contiguous()
        del m
        if i == 0:
            torch.linalg.solve(a_[:64], b_[:64])  # warm-up
        _, ms = timed_call(torch.linalg.solve, a_, b_)
        lib_ms += ms
        del a_, b_
    if not bits:
        fail(f"{name}: the AC kernel's x is not bit-identical to ac_plain's")
    nsys = b * len(freqs)
    out = dict(err=err, k_ms=k_ms, p_ms=p_ms, lib_ms=lib_ms, systems=nsys,
               n2=n2, flops=nsys * ac_flops(np1),
               nbytes=nbytes(g, bh, r, om) + nsys * n2 * 8)
    del kr, ki, g, bh, r, om, tk
    free()
    return out


def ac_body(n2):
    """The body the AC kernel runs on systems of 2N = n2 (csrc/ac_kernel.cu
    tsr_ac)."""
    if n2 <= 64:
        return "a warp segment"
    return solve.body(n2)


def lc16_phase(lanes, smi, chunk=16384):
    """Phase 30: the main path lc16_ac_8192: a 16-section LC ladder (np1 =
    36, a 72 x 72 AC system), C spread 0.1, through run_ac_batch: the
    linear OP as the bias (one launch of the stamped solve's warp
    instantiation, n = 36), then one AC launch for the 8192 x 21 = 172,032
    systems (a block a system, row i on thread i, gj_rows' bucket of 72),
    no GJ launch; |V(n16)| = 0.5 at 10 kHz.  The AC kernel against ac_plain
    on every system (in chunks of instances), torch.linalg.solve as the
    yardstick.  Then the general branch (TOYSPICE_AC=general): one stamped
    and one GJ launch, the GJ kernel against gj_plain on its 172,032 dense
    systems (in chunks), bit for bit on every system, and its x against
    the AC kernel's within rtol 2e-9 of the scale."""
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(lc_ladder(16), c_spread, lanes)
    freqs = ac_freqs(cc)
    if cc.np1 != 36 or len(freqs) != 21:
        fail("lc16: np1 is not 36 or the frequencies are not 21")
    fn = make_ac_batch(cc, axes)
    if fn.engine != "fused":
        fail(f"lc16 AC engine {fn.engine!r}, expected 'fused'")
    small = {k_: {kk: (v[:64] if v.ndim == 2 else v) for kk, v in t.items()}
             for k_, t in params.items()}
    fn(small, state0, freqs)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("lc16 AC main path", got, {"stamped_solve": (1, 1),
                                            "ac_kernel": (1, 1)})
    nf = len(freqs)
    out = cc.netlist.nodes["n16"]
    if xr.shape != (lanes, nf, cc.np1) or not bool(
            torch.isfinite(xr).all() & torch.isfinite(xi).all()) or not bool(
                opr.converged.all()):
        fail("lc16 AC: wrong shape, a value not finite, or a bias not "
             "converged")
    mag = torch.sqrt(xr[:, :, out] ** 2 + xi[:, :, out] ** 2)
    if not bool(((mag[:, 0] - 0.5).abs() < 1e-4).all()):
        fail("lc16 AC: |V(n16)| at 10 kHz is not half the source")
    fused = ac_vs_plain("lc16 AC kernel", cc, params, axes, state0, freqs,
                        (xr, xi), chunk=max(1, chunk // nf))
    fused.update(launches=got["ac_kernel"], wall=wall)
    phase("30 lc16_ac_8192 main path", t0,
          f"lc16 (np1={cc.np1}): engine {fn.engine} ({fn.engine_reason}), "
          f"stamped-solve launches={got['stamped_solve']}, AC kernel "
          f"launches={got['ac_kernel']} for {fused['systems']} systems of "
          f"{fused['n2']} ({ac_body(fused['n2'])}), no GJ launch, "
          f"wall={wall:.6f} s, {fused['systems'] / wall:.6e} systems/s on "
          f"{smi}; |V(n16)| {float(mag[:, 0].mean()):.6f} at 10 kHz, "
          f"{float(mag[:, 10].mean()):.6f} at {freqs[10]:.6g} Hz, "
          f"{float(mag[:, -1].max()):.3e} at 100 MHz; AC kernel "
          f"{fused['k_ms']:.3f} ms, plain {fused['p_ms']:.1f} ms in chunks "
          f"of {max(1, chunk // nf)} instances, bit-identical, max abs err "
          f"{fused['err']:.3e}; torch.linalg.solve {fused['lib_ms']:.3f} ms "
          "(same chunks)")

    t0 = time.perf_counter()
    with override("TOYSPICE_AC", "general"):
        fg = make_ac_batch(cc, axes)
        if fg.engine != "general":
            fail(f"lc16 under TOYSPICE_AC=general: engine {fg.engine!r}")
        fg(small, state0, freqs)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        w0 = time.perf_counter()
        gr, gi, _ = ts.run_ac_batch(cc, params, axes, freqs)
        torch.cuda.synchronize()
        g_wall = time.perf_counter() - w0
    g_got = counts()
    check_counts("lc16 AC general branch", g_got, {"stamped_solve": (1, 1),
                                                   "gj_kernel": (1, 1)})
    scale = float(torch.maximum(xr.abs().max(), xi.abs().max()))
    d = float(torch.maximum((gr - xr).abs().max(), (gi - xi).abs().max()))
    if not (bool(torch.isfinite(gr).all() & torch.isfinite(gi).all())
            and bool(((gr - xr).abs() <= 2e-9 * (xr.abs() + scale)).all())
            and bool(((gi - xi).abs() <= 2e-9 * (xi.abs() + scale)).all())):
        fail(f"lc16: the general branch's x differs from the AC kernel's "
             f"beyond rtol 2e-9 of the scale (max abs {d:.3e})")
    del xr, xi, gr, gi
    free()
    gk = TimedSolve(solve.linear_solve)
    kr, ki, _ = make_ac(cc, dense_solve=gk)(params, state0, freqs)
    a2, b2 = gk.args[0]
    k_ms = gk.ms()
    x = torch.cat([kr, ki], dim=-1).reshape(-1, 2 * cc.np1)
    del kr, ki
    _, k2_ms = timed_call(solve.launch_gj, a2, b2)
    p_ms, err, bits = 0.0, 0.0, True
    for i in range(0, a2.shape[0], chunk):
        xp, ms = timed_call(solve.gj_plain, a2[i:i + chunk], b2[i:i + chunk])
        p_ms += ms
        err = max(err, max_err("lc16 GJ", [("x", x[i:i + chunk], xp)]))
        bits = bits and same_bits(x[i:i + chunk], xp)
        del xp
    if not bits:
        fail("lc16: the GJ kernel's x is not bit-identical to gj_plain's")
    torch.linalg.solve(a2[:1024], b2[:1024])  # warm-up
    _, lib_ms = timed_call(torch.linalg.solve, a2, b2)
    nsys = a2.shape[0]
    gj_ac = dict(launches=g_got["gj_kernel"], err=err, k_ms=k2_ms,
                 p_ms=p_ms, lib_ms=lib_ms, systems=nsys, n=a2.shape[1],
                 flops=nsys * lu_flops(a2.shape[1]),
                 nbytes=nbytes(a2, b2) + nbytes(b2))
    phase("30 lc16_ac_8192 general branch", t0,
          f"lc16 under TOYSPICE_AC=general: engine {fg.engine} "
          f"({fg.engine_reason}), stamped-solve launches="
          f"{g_got['stamped_solve']}, GJ kernel launches="
          f"{g_got['gj_kernel']} for {nsys} systems of {a2.shape[1]}, "
          f"wall={g_wall:.6f} s (the AC kernel's {wall:.6f} s), "
          f"{nsys / g_wall:.6e} systems/s on {smi}; x within rtol 2e-9 of "
          f"the AC kernel's (max abs diff {d:.3e}, scale {scale:.3e}); GJ "
          f"kernel {k2_ms:.3f} ms (in the path {k_ms:.3f} ms), plain "
          f"{p_ms:.1f} ms in chunks of {chunk}, max abs err {err:.3e}, "
          f"bit-identical {bits}; torch.linalg.solve {lib_ms:.3f} ms")
    del a2, b2, x, gk
    free()
    return gj_ac, fused


def diode_string(count):
    """``count`` diodes in series from a swept 0-40 V source through 1 kΩ
    (np1 = count + 3; tests/test_torch_wide_bucket.py)."""
    lines = ["* diode string", ".dc V1 0 40 5", "V1 1 0 DC 20", "R1 1 2 1k"]
    lines += [f"D{k} {k + 2} {k + 3} DM" for k in range(count - 1)]
    lines += [f"D{count - 1} {count + 1} 0 DM", ".model DM D (Is=1e-14)",
              ""]
    return "\n".join(lines)


def magnetic_ladder(diode=False, sections=28, tstop="1m"):
    """TRANS_SMALL's secondary into an RC ladder of ``sections`` sections
    (np1 = sections + 7), with ``diode`` a diode and an RC load at its end
    (np1 = sections + 8), to ``tstop`` (tests/test_torch_wide_bucket.py)."""
    lines = ["Rl1 3 m1 20", "Cl1 m1 0 10n"]
    for k in range(2, sections + 1):
        lines += [f"Rl{k} m{k - 1} m{k} 20", f"Cl{k} m{k} 0 10n"]
    end = f"m{sections}"
    lines += ([f"D1 {end} d DMOD", "Rload d 0 1k", "Cload d 0 10u",
               ".model DMOD D(IS=1e-14)"] if diode
              else [f"Rload {end} 0 1000"])
    return TRANS_SMALL.replace("Rload 3 0 1000", "\n".join(lines)).replace(
        ".tran 20u 1m", f".tran 20u {tstop}")


def parallel_mosfets(count):
    """``count`` diode-connected NMOS in parallel behind 1 kΩ (np1 = 4),
    whose value slots overflow the 4-row bucket's block: the run kernel
    takes the 64-row bucket (tests/test_torch_wide_bucket.py)."""
    lines = ["* diode-connected nmos", ".tran 1u 20u",
             "V1 1 0 SIN(3 2 100k)", "R1 1 2 1k", "C1 2 0 1n"]
    lines += [f"M{k} 2 2 0 0 NM L=2u W={10 + k}u" for k in range(count)]
    lines += [".model NM NMOS(Vto=1 Kp=2e-5)", ""]
    return "\n".join(lines)


# phase 35's transients: (name, deck, semantics, trap), each through
# make_tran_batch, then its instantiation of the 64-row bucket against its
# plain version
WIDE_RUNS = (
    ("linear", rc_ladder(61), "compat", False),
    ("physics_be", cockcroft_walton(16, "0.1m"), "physics", False),
    ("physics", cockcroft_walton(16, "0.1m"), "physics", True),
    ("magnetic", magnetic_ladder(), "compat", False),
    ("physics_magnetic", magnetic_ladder(), "physics", True),
    ("magnetic_newton", magnetic_ladder(True), "compat", False),
    ("physics_magnetic_newton", magnetic_ladder(True), "physics", True),
    ("promoted", parallel_mosfets(30), "compat", False))


def runs_vs_plain(runs, lanes, label):
    """Each (name, deck, semantics, trap) of ``runs`` at ``lanes`` lanes, R
    and C spread: through make_tran_batch with the launch counts set to 0
    just before (engine "run", one run launch, no lane failed, every lane
    at tstop), then its instantiation against its plain version bit for
    bit, the path's counters equal to the kernel's.  Returns each one's
    launches, max abs err, kernel and plain ms, bound's work and launch
    shape (``run.segment_shape``)."""
    res = {}
    for name, deck, semantics, trap in runs:
        t0 = time.perf_counter()
        opts = ts.SimOptions(integration="trap" if trap else "be")
        cc, cfg, params, axes, state0 = setup(deck, rc_spread, lanes)
        fn = ts.make_tran_batch(cc, cfg, axes, semantics=semantics,
                                opts=opts)
        if fn.engine != "run":
            fail(f"{label} {name}: engine {fn.engine!r} "
                 f"({fn.engine_reason})")
        fn(params, state0)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = fn(params, state0)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"{label} {name} path", got, {
            "run_kernel": (1, 1), "op_kernel": (0, 1 << 30),
            "stamped_solve": (0, 1 << 30), "gj_kernel": (0, 1 << 30)})
        if bool(out.fail.any()) or not bool((out.t_final == cfg.tstop).all()):
            fail(f"{label} {name}: a lane failed or stopped early")
        plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0,
                                                  opts, semantics)
        shape = run.segment_shape(plan, lanes)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
        e = compare_run(f"{label} {name}", k, p, check_jv=jv0 is not None)
        if not (torch.equal(out.attempts, k.attempts)
                and torch.equal(out.nr_iters, k.nr_iters)
                and torch.equal(out.t_final, k.t)):
            fail(f"{label} {name}: the path differs from a kernel run")
        res[name] = dict(launches=got["run_kernel"], err=e, k_ms=k_ms,
                         p_ms=p_ms, shape=shape,
                         flops=run_bound(plan, k, semantics == "physics"),
                         nbytes=run_nbytes(plan, dev, src, st, jv0, lanes))
        phase(label, t0,
              f"{name} ({semantics}/{'trap' if trap else 'be'}, np1="
              f"{plan.np1}, {sum(plan.counts[5:])} D/Q/M): {lanes} lanes, "
              f"{shape[0]} threads a lane, {shape[1]} lanes a block, "
              f"{shape[4]} B of shared memory a block, {shape[5]} doubles "
              f"a slice in device memory; launches {got}; accepted "
              f"{int(k.accepted.sum())}, attempts {int(k.attempts.sum())}, "
              f"NR iterations {int(k.nr_iters.sum())}, failed 0; counters "
              f"equal, bit for bit, max abs err {e:.3e}; kernel {k_ms:.3f} "
              f"ms, plain {p_ms:.1f} ms")
        del k, p, out
    return res


def store_stream_vs_plain(label, deck, lanes, want):
    """``deck`` with store='full' at ``lanes`` lanes, R and C spread,
    through make_tran_batch with the counts set to 0 just before (``want``:
    the launches besides the store's one); the store instantiation against
    its plain version bit for bit; then its stream in chunks of a third of
    the most rows a lane keeps (stream_transient_chunks, counted the same
    way): every chunk's rows and the totals equal to the single launch's,
    and the second chunk's re-entry bit for bit with the plain store.
    Returns the store's launches, max abs err, kernel ms alone and with
    the wrapper, plain ms, bound's work, the rows kept, the chunk's rows
    and the chunks."""
    cc, cfg, params, axes, state0 = setup(deck, rc_spread, lanes)
    fn = ts.make_tran_batch(cc, cfg, axes, store="full")
    if fn.engine != "store":
        fail(f"{label} store: engine {fn.engine!r}")
    fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    whole = fn(params, state0)
    torch.cuda.synchronize()
    got = counts()
    check_counts(f"{label} store path", got,
                 {**want, "run_kernel_store": (1, 1)})
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
    keep = run.Store(cfg.tstart, cfg.max_store)
    k, kw, e, k_ms, w_ms, p_ms = store_vs_plain(f"{label} store", plan, dev,
                                                src, st, sc, keep, jv0)
    if not (torch.equal(whole.out_n, kw.out_n)
            and same_bits(whole.out_x, kw.out_x)):
        fail(f"{label} store: the path's rows differ from a store launch's")
    res = dict(launches=got["run_kernel_store"], k_ms=k_ms, w_ms=w_ms,
               p_ms=p_ms, flops=run_bound(plan, k, False),
               nbytes=run_nbytes(plan, dev, src, st, jv0, lanes)
               + nbytes(kw.out_x, kw.out_t), rows=int(kw.out_n.sum()))
    chunk = int(kw.out_n.max()) // 3 + 1
    reset_counts()
    parts = list(ts.stream_transient_chunks(cc, cfg, params, state0, chunk))
    torch.cuda.synchronize()
    check_counts(f"{label} stream path", counts(), {
        **want, "run_kernel_store": (len(parts), len(parts))})
    n0 = torch.zeros(lanes, dtype=torch.long, device=DEVICE)
    for w in parts:
        for lane in range(lanes):
            a, b = int(n0[lane]), int(w.out_n[lane])
            if not (torch.equal(w.out_x[lane, :b], kw.out_x[lane, a:a + b])
                    and torch.equal(w.out_t[lane, :b],
                                    kw.out_t[lane, a:a + b])):
                fail(f"{label} stream: lane {lane}'s rows differ from the "
                     "monolithic store's")
        n0 += w.out_n.long()
    if not (torch.equal(n0, kw.out_n.long())
            and torch.equal(parts[-1].attempts, k.attempts)):
        fail(f"{label} stream: the chunks' totals differ from the "
             "monolithic store's")
    # the second chunk's re-entry against the plain store
    again = run.Store(cfg.tstart, chunk, True)
    start = run.RunStart(parts[0].t_final, parts[0].dt_final,
                         parts[0].attempts)
    st1 = run_plan.init_state_stack(plan, parts[0].state, lanes, DEVICE)
    jv1 = (run_plan.jv_stack(plan, parts[0].jv, lanes) if plan.nonlinear
           else None)
    k1, w1 = run.launch_store_kernel(plan, dev, src, st1, sc, again, jv1,
                                     start=start)
    p1, pw1 = run.store_plain(plan, dev, src, st1, sc, again, jv1, start)
    res["err"] = max(e, compare_run(f"{label} stream re-entry", k1, p1,
                                    check_jv=jv1 is not None),
                     wave_err(f"{label} stream re-entry", w1, pw1))
    res.update(chunk=chunk, chunks=len(parts))
    return res


def wide_phase(lanes, main_lanes, smi):
    """Phase 35: every other instantiation of the 64-row bucket (np1 33 to
    64, a whole warp a lane), ``lanes`` lanes, R and C spread, each
    through its entry point with the launch counts set to 0 just before
    (make_tran_batch, run_op_batch, run_dc_batch), then held bit for bit
    to its plain version: WIDE_RUNS (compat linear at np1 = 64; cw16 under
    physics, BE and trap, to 0.1 ms; the magnetic ladder, compat and
    physics/trap, linear and with a diode; a 4-row deck of 30 MOSFETs
    that takes the 64-row bucket), the store (cw16 to 0.1 ms with
    store='full') and a streamed stitch of it, cw16's OP under physics,
    and the DC sweep of a string of 32 diodes, compat at ``main_lanes``
    lanes and physics at ``lanes``.  Returns each one's launches, max abs
    err, kernel and plain ms and bound's work."""
    res = runs_vs_plain(WIDE_RUNS, lanes, "35 64-row bucket vs plain")
    if any(r["shape"][0] != 32 for r in res.values()):
        fail("wide: a run's segments are not a warp")

    # the store: cw16 to 0.1 ms with store='full', then a streamed stitch
    t0 = time.perf_counter()
    store_wide = store_stream_vs_plain("wide", cockcroft_walton(16, "0.1m"),
                                       lanes, {"op_kernel": (1, 1)})
    phase("35 64-row bucket vs plain", t0,
          f"store (cw16 to 0.1 ms, store='full'): {lanes} lanes, OP "
          f"launches 1, store launches 1, stored rows {store_wide['rows']}, "
          f"bit for bit with store_plain, kernel {store_wide['k_ms']:.3f} "
          f"ms alone ({store_wide['w_ms']:.3f} ms with the wrapper), plain "
          f"{store_wide['p_ms']:.1f} ms; streamed in chunks of "
          f"{store_wide['chunk']} rows: {store_wide['chunks']} store "
          f"launches, every chunk's rows and the totals equal to the "
          f"monolithic store's, the re-entry bit for bit with the plain "
          f"store; max abs err {store_wide['err']:.3e}")

    # cw16's OP under physics
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(cockcroft_walton(16), c_spread,
                                        lanes)
    reset_counts()
    opr = ts.run_op_batch(cc, params, axes, semantics="physics")
    torch.cuda.synchronize()
    check_counts("wide physics OP path", counts(), {"op_kernel": (1, 1)})
    po = op.make_op_fused(cc, DEFAULTS, "physics", solve=op.op_plain)(
        params, state0)
    for key in ("converged", "stage", "iters", "iters_all"):
        if not torch.equal(getattr(opr, key), getattr(po, key)):
            fail(f"wide physics OP: {key} differs from op_plain")
    res["op_physics_err"] = exact_err("wide physics OP", [
        ("x", opr.x, po.x)] + [(f"jv.{kd}.{key}", opr.jv[kd][key],
                                po.jv[kd][key])
                               for kd in po.jv for key in po.jv[kd]])
    phase("35 64-row bucket vs plain", t0,
          f"cw16's OP (physics): {lanes} lanes, OP launches 1, converged "
          f"{int(opr.converged.sum())}, bit for bit with op_plain")

    # the DC sweep of 32 diodes: compat on main_lanes lanes, physics
    pts = np.linspace(0.0, 40.0, 9)
    for semantics, b in (("compat", main_lanes), ("physics", lanes)):
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(diode_string(32), rc_spread, b)
        reset_counts()
        xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts,
                                   semantics=semantics)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"wide DC {semantics} path", got,
                     {"dc_sweep_kernel": (1, 1)})
        if not bool(conv.all()) or not bool(torch.isfinite(xs).all()):
            fail(f"wide DC {semantics}: a point did not converge")
        tk, tp_ = TimedSolve(dc.dc_lanes), TimedSolve(dc.dc_plain)
        kd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=tk)(
            params, state0, pts)
        pd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=tp_)(
            params, state0, pts)
        for key in ("conv", "iters"):
            if not torch.equal(getattr(kd, key), getattr(pd, key)):
                fail(f"wide DC {semantics}: {key} differs from dc_plain")
        ed = exact_err(f"wide DC {semantics}", [
            ("xs", kd.xs.reshape(-1, cc.np1), pd.xs.reshape(-1, cc.np1)),
            ("xs", xs.reshape(-1, cc.np1), pd.xs.reshape(-1, cc.np1))])
        plan_dc, dev_, dyn_, vs_, _ = tk.args[0]
        dc_it = int(kd.iters.sum())
        per_it = (phys_newton_flops(plan_dc) if semantics == "physics"
                  else newton_flops(plan_dc)) - (plan_dc.np1 - 1)
        res[f"dc_{semantics}"] = dict(
            launches=got["dc_sweep_kernel"], err=ed, k_ms=tk.ms(),
            p_ms=tp_.ms(), flops=int(dc_it * per_it),
            nbytes=nbytes(dev_, dyn_, vs_, kd.xs) + plan_dc.topo.nbytes
            + b * len(pts) * 8)
        phase("35 64-row bucket vs plain", t0,
              f"DC sweep of 32 diodes ({semantics}, np1={cc.np1}): {b} "
              f"lanes x {len(pts)} points in one launch, all converged, "
              f"Newton iterations {dc_it}; equal counts, bit for bit, max "
              f"abs err {ed:.3e}; kernel {res[f'dc_{semantics}']['k_ms']:.3f}"
              f" ms, plain {res[f'dc_{semantics}']['p_ms']:.1f} ms on {smi}")
        del xs, kd, pd, tk, tp_
    free()
    res["store"] = store_wide
    return res


# ------------------------------------------------------ 36 the block bucket


# phase 36's transients at 259 lanes: (name, deck, semantics, trap), each
# through make_tran_batch (counts reset before), then the block bucket's
# run instantiation against its plain version
BLOCK_RUNS = (
    ("linear", rc_ladder(62), "compat", False),
    ("physics_be", cockcroft_walton(32, "0.1m"), "physics", False),
    ("physics", cockcroft_walton(32, "0.1m"), "physics", True),
    ("magnetic", magnetic_ladder(False, 60, "0.2m"), "compat", False),
    ("physics_magnetic", magnetic_ladder(False, 60, "0.2m"), "physics",
     True),
    ("magnetic_newton", magnetic_ladder(True, 60, "0.2m"), "compat", False),
    ("physics_magnetic_newton", magnetic_ladder(True, 60, "0.2m"),
     "physics", True),
    ("device_memory", rc_ladder(180), "compat", False))


def block_phase(lanes, main_lanes, smi, rc_general):
    """Phase 36: the block bucket of the run, store, OP and DC sweep
    kernels (np1 past 64: a lane on a whole block of 256 threads, its
    system built and eliminated by gj_block in the block's slice, shared
    memory while it fits, else a slice of a device-memory workspace).
    Main paths at ``main_lanes`` lanes, lanes from numpy default_rng(0),
    counts set to 0 just before and read just after: rc127_8192 (np1 =
    130, C spread 0.1, to 0.05 ms: one run launch, no stamped or GJ launch),
    printed beside phase 32's run and general engines at 1024 lanes
    (``rc_general``); cw32_8192 (a 32-stage Cockcroft-Walton multiplier,
    np1 = 67, 64 diodes, to 2 ms: one OP launch, then one run launch); the
    DC sweep of a string of 64 diodes (np1 = 67) at 9 points, one launch.
    Each main path's run launch alone on its inputs, and the kernel
    against its plain version bit for bit on ``lanes`` of its lanes (cw32
    over the first 0.1 ms).  Then at ``lanes`` lanes, each through its
    entry point (counts reset before) and then bit for bit against its
    plain version: BLOCK_RUNS (compat linear at np1 = 65; cw32 under
    physics BE and trap to 0.1 ms; TRANS_SMALL's secondary into a
    60-section RC ladder, np1 = 67, compat and physics/trap, and with a
    diode at its end, the magnetic Newton ones; a 180-stage ladder, np1 =
    183, on the device-memory workspace), rc127 with store='full' and its
    stream in 3 chunks stitched bit for bit with the single launch, cw32's
    OP under physics and the physics diode-string sweep.  Returns each
    one's launches, max abs err, kernel and plain ms and bound's work."""
    res = {}

    # ---- rc127_8192
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(rc_ladder(127), c_spread,
                                          main_lanes)
    ts.make_tran_batch(cc, cfg._replace(tstop=1e-5), axes)(
        params, state0)  # warm-up
    fn = ts.make_tran_batch(cc, cfg, axes)
    if fn.engine != "run" or cc.np1 != 130:
        fail(f"rc127_8192: engine {fn.engine!r} ({fn.engine_reason}), np1 "
             f"{cc.np1}")
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("rc127_8192 main path", got, {"run_kernel": (1, 1)})
    if bool(out.fail.any()) or not bool((out.t_final == cfg.tstop).all()):
        fail("rc127_8192: a lane failed or stopped early")
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
    shape = run.segment_shape(plan, main_lanes)
    k, main_ms = timed_call(run.launch_run_kernel, plan, dev, src, st, sc,
                            jv0)
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.t_final, k.t)):
        fail("rc127_8192: the path differs from a run launch on its inputs")
    cut = [x[:lanes] for x in (dev, src, st)]
    kc, kc_ms, pc, pc_ms = kernel_vs_plain(plan, *cut, sc)
    err = compare_run("rc127 block run vs plain", kc, pc)
    if not torch.equal(kc.accepted, out.accepted[:lanes]):
        fail("rc127: the cut's counters differ from the main path's")
    accepted = int(out.accepted.sum())
    res["rc127"] = dict(
        launches=got["run_kernel"], err=err, k_ms=kc_ms, p_ms=pc_ms,
        flops=run_bound(plan, kc, False),
        nbytes=run_nbytes(plan, *cut, None, lanes), main_ms=main_ms,
        main_flops=run_bound(plan, k, False),
        main_bytes=run_nbytes(plan, dev, src, st, None, main_lanes))
    mb = bound(res["rc127"]["main_flops"], res["rc127"]["main_bytes"])
    phase("36 rc127_8192 main path", t0,
          f"127-stage rc ladder (np1={cc.np1}): engine={fn.engine} "
          f"({fn.engine_reason}), run kernel launches={got['run_kernel']}, "
          f"no stamped or GJ launch; launch shape (the library's): "
          f"{shape[3]} threads a block, {shape[2]} blocks, {shape[4]} B of "
          f"shared memory a block, {shape[5]} doubles a slice in device "
          f"memory; lanes={main_lanes}, accepted={accepted}, attempts="
          f"{int(out.attempts.sum())}, failed=0, every lane at tstop; "
          f"wall={wall:.6f} s, {accepted / wall:.6e} accepted steps/s; the "
          f"run launch alone {main_ms:.3f} ms, bound {mb[0]:.6f} ms "
          f"({mb[1]}); on {lanes} of its lanes kernel {kc_ms:.3f} ms, "
          f"plain {pc_ms:.1f} ms, counters equal, bit for bit, max abs err "
          f"{err:.3e}; phase 32 at 1024 lanes: the run engine "
          f"{rc_general['run_wall']:.6f} s, the general engine "
          f"{rc_general['wall']:.6f} s "
          f"({rc_general['accepted'] / rc_general['wall']:.6e} against "
          f"{rc_general['accepted'] / rc_general['run_wall']:.6e} accepted "
          f"steps/s); on {smi}")
    del out, k, kc, pc
    free()

    # ---- cw32_8192: one OP launch, then one run launch
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(cockcroft_walton(32), c_spread,
                                          main_lanes)
    if cc.np1 != 67 or cc.kind_count("D") != 64:
        fail("cw32: np1 is not 67 or the diodes are not 64")
    short = cfg._replace(tstop=1e-4)
    ts.make_tran_batch(cc, cfg._replace(tstop=1e-5), axes)(
        params, state0)  # warm-up
    fn = ts.make_tran_batch(cc, cfg, axes)
    if fn.engine != "run":
        fail(f"cw32 engine {fn.engine!r} ({fn.engine_reason})")
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("cw32 main path", got, {"op_kernel": (1, 1),
                                         "run_kernel": (1, 1)})
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"cw32 main path: {failed} of {main_lanes} lanes failed or "
             "stopped early")
    vc = out.state["C"]["v0"]
    if not bool(torch.isfinite(vc).all()) or not bool(
            (vc.abs() < 6400.0).all()):
        fail("cw32 main path: a capacitor voltage is not finite or exceeds "
             "32 stages of 200 V")
    accepted = int(out.accepted.sum())
    nri = out.nr_iters
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
    k, main_ms = timed_call(run.launch_run_kernel, plan, dev, src, st, sc,
                            jv0)
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.nr_iters, k.nr_iters)
            and torch.equal(out.t_final, k.t)):
        fail("cw32 main path differs from a run launch on its inputs")
    main_flops, main_bytes = (run_bound(plan, k, False),
                              run_nbytes(plan, dev, src, st, jv0, main_lanes))
    del k
    sc_short = sc._replace(tstop=short.tstop)
    cut = [x[:lanes] for x in (dev, src, st, jv0)]
    kc, kc_ms, pc, pc_ms = kernel_vs_plain(plan, *cut[:3], sc_short, cut[3])
    err = compare_run("cw32 block run vs plain, first 0.1 ms", kc, pc,
                      check_jv=True)
    res["newton"] = dict(launches=got["run_kernel"], err=err, k_ms=kc_ms,
                         p_ms=pc_ms, flops=run_bound(plan, kc, False),
                         nbytes=run_nbytes(plan, *cut, lanes),
                         main_ms=main_ms, main_flops=main_flops,
                         main_bytes=main_bytes)
    del kc, pc
    # the OP kernel against its plain version on the main path's lanes
    tk, tp_ = TimedSolve(op.op_lanes), TimedSolve(op.op_plain)
    ko = op.make_op_fused(cc, DEFAULTS, solve=tk)(params, state0)
    po = op.make_op_fused(cc, DEFAULTS, solve=tp_)(params, state0)
    for key in ("converged", "stage", "iters", "iters_all"):
        if not torch.equal(getattr(ko, key), getattr(po, key)):
            fail(f"cw32 OP: {key} differs between the kernel and op_plain")
    if not bool(ko.converged.all()):
        fail("cw32 OP: a lane did not converge")
    plan_op = tk.args[0][0]
    res["op"] = dict(
        launches=got["op_kernel"],
        err=exact_err("cw32 OP", [("x", ko.x, po.x)] + [
            (f"jv.{kd}.{key}", ko.jv[kd][key], po.jv[kd][key])
            for kd in po.jv for key in po.jv[kd]]),
        k_ms=tk.ms(), p_ms=tp_.ms(),
        flops=int(ko.iters_all.sum()) * newton_flops(plan_op) + main_lanes
        * (build_flops(plan_op, plan_op.entries[:plan_op.n_lin])
           + lu_flops(plan_op.np1)),
        nbytes=len(tk.events) * (main_lanes * (8 * (
            plan_op.nd + op.dyn_width(plan_op)
            + 2 * (plan_op.np1 + plan_op.kj)) + 8) + plan_op.topo.nbytes))
    del ko, po, tk, tp_
    mb = bound(main_flops, main_bytes)
    phase("36 cw32_8192 main path", t0,
          f"cw32 (np1={cc.np1}, {cc.kind_count('D')} diodes): engine="
          f"{fn.engine} ({fn.engine_reason}), OP kernel launches="
          f"{got['op_kernel']}, run kernel launches={got['run_kernel']}, no "
          f"stamped or GJ launch; lanes={main_lanes}, accepted={accepted}, "
          f"attempts={int(out.attempts.sum())}, failed=0, every lane at "
          f"tstop, Newton iterations per lane {int(nri.min())}.."
          f"{int(nri.max())}; wall={wall:.6f} s, {accepted / wall:.6e} "
          f"accepted steps/s; the run launch alone {main_ms:.3f} ms, bound "
          f"{mb[0]:.6f} ms ({mb[1]}); the run kernel vs run_plain on "
          f"{lanes} lanes over the first 0.1 ms: kernel "
          f"{res['newton']['k_ms']:.3f} ms, plain "
          f"{res['newton']['p_ms']:.1f} ms, counters equal, bit for bit, "
          f"max abs err {err:.3e}; the OP kernel vs op_plain on the main "
          f"path's lanes: bit for bit, kernel {res['op']['k_ms']:.3f} ms, "
          f"plain {res['op']['p_ms']:.1f} ms; on {smi}")
    del out
    free()

    # ---- the DC sweep of 64 diodes: compat at main_lanes, physics at lanes
    pts = np.linspace(0.0, 40.0, 9)
    for semantics, b in (("compat", main_lanes), ("physics", lanes)):
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(diode_string(64), rc_spread, b)
        reset_counts()
        w0 = time.perf_counter()
        xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts,
                                   semantics=semantics)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        got = counts()
        check_counts(f"block DC {semantics} path", got,
                     {"dc_sweep_kernel": (1, 1)})
        if not bool(conv.all()) or not bool(torch.isfinite(xs).all()):
            fail(f"block DC {semantics}: a point did not converge")
        # the plain version on `lanes` of the lanes
        sub = {k_: {kk: (v[:lanes] if v.ndim == 2 else v)
                    for kk, v in t.items()} for k_, t in params.items()}
        tk, tp_ = TimedSolve(dc.dc_lanes), TimedSolve(dc.dc_plain)
        kd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=tk)(
            sub, state0, pts)
        pd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=tp_)(
            sub, state0, pts)
        for key in ("conv", "iters"):
            if not torch.equal(getattr(kd, key), getattr(pd, key)):
                fail(f"block DC {semantics}: {key} differs from dc_plain")
        ed = exact_err(f"block DC {semantics}", [
            ("xs", kd.xs.reshape(-1, cc.np1), pd.xs.reshape(-1, cc.np1)),
            ("xs", xs[:lanes].reshape(-1, cc.np1),
             pd.xs.reshape(-1, cc.np1))])
        plan_dc, dev_, dyn_, vs_, _ = tk.args[0]
        dc_it = int(kd.iters.sum())
        per_it = (phys_newton_flops(plan_dc) if semantics == "physics"
                  else newton_flops(plan_dc)) - (plan_dc.np1 - 1)
        res[f"dc_{semantics}"] = dict(
            launches=got["dc_sweep_kernel"], err=ed, k_ms=tk.ms(),
            p_ms=tp_.ms(), flops=int(dc_it * per_it),
            nbytes=nbytes(dev_, dyn_, vs_, kd.xs) + plan_dc.topo.nbytes
            + lanes * len(pts) * 8)
        phase("36 diode_string64_sweep", t0,
              f"DC sweep of 64 diodes ({semantics}, np1={cc.np1}): {b} "
              f"lanes x {len(pts)} points in one launch, all converged, "
              f"wall {wall:.6f} s, {b * len(pts) / wall:.6e} points/s; on "
              f"{lanes} of the lanes: Newton iterations {dc_it}, equal "
              f"counts, bit for bit, max abs err {ed:.3e}; kernel "
              f"{res[f'dc_{semantics}']['k_ms']:.3f} ms, plain "
              f"{res[f'dc_{semantics}']['p_ms']:.1f} ms on {smi}")
        del xs, kd, pd, tk, tp_
    free()

    # ---- every other instantiation at `lanes` lanes
    runs = runs_vs_plain(BLOCK_RUNS, lanes, "36 block bucket vs plain")
    for name, r in runs.items():
        if r["shape"][0] != 256 or (r["shape"][5] > 0) != (
                name == "device_memory"):
            fail(f"block {name}: launch shape {r['shape']}")
    res.update(runs)
    free()

    # ---- the store: rc127 with store='full', then its stream
    t0 = time.perf_counter()
    res["store"] = st_ = store_stream_vs_plain("block", rc_ladder(127),
                                               lanes, {})
    if st_["chunks"] != 3:
        fail(f"block stream: {st_['chunks']} chunks, not 3")
    phase("36 block bucket vs plain", t0,
          f"store (rc127, np1=130, store='full'): {lanes} lanes, store "
          f"launches 1, stored rows {st_['rows']}, bit for bit with "
          f"store_plain, kernel {st_['k_ms']:.3f} ms alone "
          f"({st_['w_ms']:.3f} ms with the wrapper), plain "
          f"{st_['p_ms']:.1f} ms; streamed in chunks of {st_['chunk']} "
          f"rows: {st_['chunks']} store launches, every chunk's rows and "
          f"the totals equal to the single launch's, the re-entry bit for "
          f"bit with the plain store; max abs err {st_['err']:.3e}")
    free()

    # ---- cw32's OP under physics
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(cockcroft_walton(32), c_spread,
                                        lanes)
    reset_counts()
    opr = ts.run_op_batch(cc, params, axes, semantics="physics")
    torch.cuda.synchronize()
    check_counts("block physics OP path", counts(), {"op_kernel": (1, 1)})
    po = op.make_op_fused(cc, DEFAULTS, "physics", solve=op.op_plain)(
        params, state0)
    for key in ("converged", "stage", "iters", "iters_all"):
        if not torch.equal(getattr(opr, key), getattr(po, key)):
            fail(f"block physics OP: {key} differs from op_plain")
    res["op_physics_err"] = exact_err("block physics OP", [
        ("x", opr.x, po.x)] + [(f"jv.{kd}.{key}", opr.jv[kd][key],
                                po.jv[kd][key])
                               for kd in po.jv for key in po.jv[kd]])
    phase("36 block bucket vs plain", t0,
          f"cw32's OP (physics): {lanes} lanes, OP launches 1, converged "
          f"{int(opr.converged.sum())}, bit for bit with op_plain")
    free()
    return res


RECTIFIER_AC = """* half-wave rectifier biased at 0.6 V, an AC source in series
.ac DEC 5 100 1meg
Vb ac m DC 0.6
Vs m 0 AC 1
Dr ac dcout DFAST
Rload dcout 0 2.7k
Csmooth dcout 0 4.7u
.model DFAST D (Is=2e-14 N=1.05 Cj0=4p Tt=5n)
"""


# ------------------------------------------------ 37 the AC kernel's buckets
# phase 37's decks: (name, deck, semantics), each through run_ac_batch at
# 259 instances x 3 frequencies (counts reset before), then the AC kernel
# against ac_plain: LC ladders at each bucket edge of csrc/ac_kernel.cu
# (lc_ladder(k) has np1 = 2k + 4: 32 the warp body, 34 and 48 gj_rows'
# buckets 72 and 96, 50 and 72 gj_wide's 127 and 144, 74 and 84 the
# pointer body in shared memory, 86 and 104 on the device-memory
# workspace), an RC ladder at np1 = 33 (odd), and 29 diodes in series (np1
# = 34) biased by the OP kernel, compat and physics
def rc_ladder_ac(stages):
    """rc_ladder's network driven by an AC source (np1 = stages + 3), 3
    frequencies from 1 kHz to 1 MHz."""
    lines = [f"* {stages}-stage rc ladder, AC", ".ac dec 3 1k 1meg",
             "Vin 1 0 AC 1"]
    for k in range(1, stages + 1):
        lines += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 1n"]
    return "\n".join(lines) + "\n"


def diode_string_ac(count):
    """``count`` diodes in series from node 2 to ground behind 1 kΩ, a 10
    pF capacitor across the string, 20 V DC with a 10 mV AC-only source in
    series (the reference parser drops the AC part of "DC x AC y"): np1 =
    count + 5 (tests/test_torch_ac_wide.py)."""
    lines = [f"* {count} diodes in series, AC", ".ac DEC 3 10k 1000meg",
             "Vdc s 0 DC 20", "Vin 1 s AC 0.01", "R1 1 2 1k", "C1 2 0 10p"]
    lines += [f"D{k} {k + 2} {k + 3} DM" for k in range(count - 1)]
    lines += [f"D{count - 1} {count + 1} 0 DM",
              ".model DM D (Is=1e-14 N=1.2 Cj0=4p Vj=0.8 M=0.4)", ""]
    return "\n".join(lines)


AC_BUCKET_DECKS = [
    (f"lc{k}", lc_ladder(k).replace(".ac dec 21 10k 100meg",
                                    ".ac dec 3 10k 100meg"), "compat")
    for k in (14, 15, 22, 23, 34, 35, 40, 41, 50)] + [
    ("rc30", rc_ladder_ac(30), "compat"),
    ("diodes29", diode_string_ac(29), "compat"),
    ("diodes29_physics", diode_string_ac(29), "physics")]


def ac_bucket_phase(lanes, smi):
    """Phase 37: the AC kernel's buckets at ``lanes`` instances x 3
    frequencies, each deck of AC_BUCKET_DECKS through run_ac_batch (engine
    "fused"; one stamped launch, or the OP kernel's, then one AC launch; no
    GJ launch; every bias converged, every x finite), then the AC kernel
    against ac_plain on the same inputs, bit for bit, beside
    torch.linalg.solve.  Returns each deck's figures by name."""
    out = {}
    for name, deck, semantics in AC_BUCKET_DECKS:
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(deck, c_spread, lanes)
        freqs = ac_freqs(cc)
        fn = make_ac_batch(cc, axes, DEFAULTS, semantics)
        if fn.engine != "fused" or len(freqs) != 3:
            fail(f"37 {name}: engine {fn.engine!r} ({fn.engine_reason}), "
                 f"{len(freqs)} frequencies")
        fn(params, state0, freqs)  # warm-up
        bias = ({"op_kernel": (1, 1 << 30)} if fn.bias_engine == "fused"
                else {"stamped_solve": (1, 1)})
        torch.cuda.synchronize()
        reset_counts()
        w0 = time.perf_counter()
        xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs,
                                      semantics=semantics)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        got = counts()
        check_counts(f"37 {name}", got, dict(bias, ac_kernel=(1, 1)))
        if not (bool(opr.converged.all()) and bool(
                torch.isfinite(xr).all() & torch.isfinite(xi).all())):
            fail(f"37 {name}: a bias not converged or a value not finite")
        r = ac_vs_plain(f"37 {name}", cc, params, axes, state0, freqs,
                        (xr, xi), semantics)
        r.update(launches=got["ac_kernel"], wall=wall, np1=cc.np1)
        out[name] = r
        phase("37 AC kernel buckets", t0,
              f"{name} ({semantics}, np1={cc.np1}, 2N={r['n2']}: "
              f"{ac_body(r['n2'])}): {lanes} x {len(freqs)} systems, "
              f"bias {fn.bias_engine} ("
              + ", ".join(f"{k} {c}" for k, c in got.items() if c)
              + f"), wall={wall:.6f} s on {smi}; AC kernel "
              f"{r['k_ms']:.3f} ms, plain {r['p_ms']:.1f} ms, bit-identical, "
              f"max abs err {r['err']:.3e}; torch.linalg.solve "
              f"{r['lib_ms']:.3f} ms")
        del xr, xi, opr
    free()
    return out


def compat_trap_phase(lanes):
    """Phase 31: compat under integration="trap" in the OP, the DC sweep
    and the AC (served as BE, as the JAX package serves them): each entry
    point's kernels launched, the result equal bit for bit to compat/BE's,
    the kernel bit-identical to its plain version; the transient still
    refuses compat/trap."""
    t0 = time.perf_counter()
    trap = ts.SimOptions(integration="trap")
    hwr = deck_file("half_wave_rectifier.cir")
    cc, cfg, params, axes, state0 = setup(hwr, rc_spread, lanes)
    hcc = cc
    pts = ts.sweep_values(-2.0, 2.0, 0.25)
    notes = []
    reset_counts()
    o = ts.run_op_batch(cc, params, opts=trap)
    xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts, opts=trap)
    torch.cuda.synchronize()
    check_counts("compat/trap OP and DC", counts(), {
        "op_kernel": (1, 1 << 30), "dc_sweep_kernel": (1, 1)})
    be = ts.run_op_batch(cc, params)
    xs_be, conv_be = ts.run_dc_batch(cc, (0,), params, axes, pts)
    if not (bool(o.converged.all()) and bool(conv.all())
            and same_bits(o.x, be.x) and same_bits(xs, xs_be)
            and torch.equal(o.stage, be.stage) and torch.equal(conv,
                                                              conv_be)):
        fail("compat/trap OP or DC sweep differs from compat/BE or did not "
             "converge")
    ok = op.make_op_fused(cc, trap, solve=op.op_lanes)(params, state0)
    opn = op.make_op_fused(cc, trap, solve=op.op_plain)(params, state0)
    dk = dc.make_dc_fused(cc, (0,), trap, solve=dc.dc_lanes)(params, state0,
                                                             pts)
    dp = dc.make_dc_fused(cc, (0,), trap, solve=dc.dc_plain)(params, state0,
                                                             pts)
    if not (same_bits(ok.x, opn.x) and torch.equal(ok.stage, opn.stage)
            and same_bits(dk.xs, dp.xs) and torch.equal(dk.conv, dp.conv)
            and torch.equal(dk.iters, dp.iters)):
        fail("compat/trap: the OP or DC sweep kernel is not bit-identical to "
             "its plain version")
    notes.append(f"OP {lanes} lanes and DC {lanes} x {len(pts)} points "
                 "equal to compat/BE, the kernels bit-identical to plain")
    cc, _, params, axes, state0 = setup(RECTIFIER_AC, rc_spread, lanes)
    a = cc.netlist.ac
    freqs = ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)
    reset_counts()
    xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs, opts=trap)
    torch.cuda.synchronize()
    check_counts("compat/trap AC", counts(), {"op_kernel": (1, 1 << 30),
                                              "ac_kernel": (1, 1)})
    xr_be, xi_be, _ = ts.run_ac_batch(cc, params, axes, freqs)
    pr, pi_, _ = make_ac_batch(cc, axes, trap, op_solve=op.op_plain,
                               ac_solve=ac.ac_plain)(params, state0, freqs)
    if not (bool(opr.converged.all()) and same_bits(xr, xr_be)
            and same_bits(xi, xi_be) and same_bits(xr, pr)
            and same_bits(xi, pi_) and bool(torch.isfinite(xr).all())):
        fail("compat/trap AC differs from compat/BE or from the plain "
             "versions")
    notes.append(f"AC {lanes} x {len(freqs)} systems of {2 * cc.np1} equal "
                 "to compat/BE and to the plain versions")
    try:
        ts.make_tran_batch(hcc, cfg, None, opts=trap)
        fail("compat/trap transient was not refused")
    except NotImplementedError as e:
        if "requires semantics='physics'" not in str(e):
            fail(f"compat/trap transient refused with {e}")
    notes.append("the transient refuses it")
    phase("31 compat/trap analyses", t0, "half_wave_rectifier: "
          + "; ".join(notes))


# ------------------------------------------------------------- past 128


def chunked(solve_fn, chunk):
    """A dense solve over chunks of ``chunk`` systems (the plain version's
    temporaries on 21,504 systems of 132 would take ~12 GB)."""
    def run_(a, b):
        return torch.cat([solve_fn(a[i:i + chunk], b[i:i + chunk])
                          for i in range(0, a.shape[0], chunk)])
    return run_


def past_nbig_phase(lanes, smi, main_lanes=BENCH_LANES):
    """Phase 32: decks past n = 128: a 127-stage RC ladder (np1 = 130)
    through make_tran_batch to 0.05 ms, engine "run" (one launch of the
    run kernel's block bucket, a block a lane, no other kernel; no lane
    failed, every lane at tstop), then under
    TOYSPICE_TRAN=general the general engine, whose stamped solve
    eliminates its systems in the registers of a 512-thread block
    (csrc/gj_block.cuh gj_wide; past NBIG = 168 in device memory, gj_block
    on each block's slice of a workspace; ops/solve.py body): one stamped
    launch per batched Newton iteration, no other kernel, counters equal
    to the run engine's and state within rtol 1e-9; and a 31-section LC
    ladder's AC (np1 = 66, 21 frequencies, systems of 132) through
    run_ac_batch at ``main_lanes`` (lc31_ac_8192: the linear OP's stamped
    launch, one AC launch of gj_wide's bucket of 144, no GJ launch; the AC
    kernel against ac_plain on every system, in chunks) and, under
    TOYSPICE_AC=general, at ``lanes`` (the linear OP's stamped launch, one
    GJ launch); then the general engine's kernels against their plain
    versions on the same lanes, counters equal and bit for bit, and
    torch.linalg.solve on the same systems.  Returns the stamped, GJ and AC
    launches' figures (rc127's walls with the stamped ones)."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(rc_ladder(127), c_spread, lanes)
    if cc.np1 != 130:
        fail(f"rc ladder past 128: np1 is {cc.np1}, not 130")
    ts.make_tran_batch(cc, cfg._replace(tstop=1e-5), axes)(params,
                                                            state0)  # warm-up
    fn = ts.make_tran_batch(cc, cfg, axes)
    if fn.engine != "run":
        fail(f"rc ladder past 128: engine {fn.engine!r} "
             f"({fn.engine_reason})")
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    kr = fn(params, state0)
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - w0
    check_counts("rc ladder past 128, run engine", counts(),
                 {"run_kernel": (1, 1)})
    if bool(kr.fail.any()) or not bool((kr.t_final == cfg.tstop).all()):
        fail("rc ladder past 128, run engine: a lane failed or stopped "
             "early")
    os.environ["TOYSPICE_TRAN"] = "general"
    try:
        fg = ts.make_tran_batch(cc, cfg, axes)
    finally:
        del os.environ["TOYSPICE_TRAN"]
    if fg.engine != "general":
        fail(f"rc ladder past 128 under TOYSPICE_TRAN=general: engine "
             f"{fg.engine!r}")
    fg(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fg(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("rc ladder past 128", got, {"stamped_solve": (1, 1 << 30)})
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"rc ladder past 128: {failed} of {lanes} lanes failed or "
             "stopped early")
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        if not torch.equal(getattr(kr, key), getattr(out, key)):
            fail(f"rc ladder past 128: {key} differs between the run and "
                 "the general engine")
    gen_err = max_err("rc ladder past 128, general engine vs run kernel", [
        ("t_final", out.t_final, kr.t_final)] + [
        (f"state.{kd}.{key}", out.state[kd][key], kr.state[kd][key])
        for kd in kr.state for key in kr.state[kd]])
    tk = TimedSolve(solve_stamped.solve_lanes, stamped_systems)
    tp_ = TimedSolve(solve_stamped.solve_plain)
    k = make_tran(cc, cfg, store="none", solve=tk)(params, state0)
    p = make_tran(cc, cfg, store="none", solve=tp_,
                  dense_solve=solve.gj_plain)(params, state0)
    calls = len(tk.args)
    if calls != got["stamped_solve"] or len(tp_.args) != calls:
        fail(f"rc ladder past 128: {got['stamped_solve']} stamped launches "
             f"on the main path, {calls} batched Newton iterations with the "
             f"kernels, {len(tp_.args)} with the plain versions")
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        if not (torch.equal(getattr(k, key), getattr(p, key))
                and torch.equal(getattr(k, key), getattr(out, key))):
            fail(f"rc ladder past 128: {key} differs between the main "
                 "path, the kernels and the plain versions")
    pairs = [(f"{who} {what}.{kd}.{key}", kt[kd][key], pt[kd][key])
             for who, run_ in (("kernels", k), ("main path", out))
             for what, kt, pt in (("state", run_.state, p.state),
                                  ("jv", run_.jv, p.jv))
             for kd in pt for key in pt[kd]]
    err = max_err("rc ladder past 128 kernels vs plain", pairs)
    if not all(same_bits(a, b) for _, a, b in pairs):
        fail("rc ladder past 128: the kernels' state or jv is not "
             "bit-identical to the plain versions'")
    pat, vals, rvals, gmin = tk.args[0]
    if pat.n != 130:
        fail(f"rc ladder past 128: the stamped systems are {pat.n}, not 130")
    accepted = int(out.accepted.sum())
    nri = out.nr_iters
    st_big = dict(launches=got["stamped_solve"], err=err, k_ms=tk.ms(),
                  p_ms=tp_.ms(), lib_ms=tk.ms(lib=True), calls=calls,
                  flops=calls * lanes * stamped_flops(pat),
                  nbytes=calls * (nbytes(vals, rvals, gmin)
                                  + pat.table.nbytes + lanes * pat.n * 8),
                  n=pat.n, terms=int(pat.table[0]), wall=wall,
                  run_wall=run_wall, accepted=accepted)
    phase("32 rc ladder past 128", t0,
          f"127-stage rc ladder (np1={cc.np1}), lanes={lanes}: engine="
          f"{fn.engine} ({fn.engine_reason}), one run-kernel launch (the "
          f"block bucket), wall={run_wall:.6f} s, "
          f"{accepted / run_wall:.6e} accepted steps/s; under "
          f"TOYSPICE_TRAN=general engine={fg.engine}, stamped-solve "
          f"launches={got['stamped_solve']} ({solve.body(pat.n)}, "
          f"n={pat.n}, {st_big['terms']} terms), one per batched Newton "
          f"iteration, no other kernel, accepted={accepted}, attempts="
          f"{int(out.attempts.sum())}, failed={failed}, every lane at "
          f"tstop, Newton iterations per lane {int(nri.min())}.."
          f"{int(nri.max())}, wall={wall:.6f} s, {accepted / wall:.6e} "
          f"accepted steps/s, counters equal to the run engine's, max abs "
          f"err {gen_err:.3e}, on {smi}; the general engine's kernels vs "
          f"their plain versions on these lanes: counters equal, "
          f"bit-identical, max abs err {err:.3e}; stamped kernel "
          f"{st_big['k_ms']:.3f} ms over {calls} launches "
          f"({st_big['k_ms'] / calls:.4f} ms a launch), plain "
          f"{st_big['p_ms']:.1f} ms, torch.linalg.solve on the built "
          f"systems {st_big['lib_ms']:.3f} ms")
    del out, k, p, tk, tp_, kr
    free()

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(lc_ladder(31), c_spread, main_lanes)
    freqs = ac_freqs(cc)
    if cc.np1 != 66 or len(freqs) != 21:
        fail("lc31: np1 is not 66 or the frequencies are not 21")
    fn = make_ac_batch(cc, axes)
    if fn.engine != "fused":
        fail(f"lc31 AC engine {fn.engine!r}, expected 'fused'")
    small = {k_: {kk: (v[:8] if v.ndim == 2 else v) for kk, v in t.items()}
             for k_, t in params.items()}
    fn(small, state0, freqs)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("lc31_ac_8192 main path", got, {"stamped_solve": (1, 1),
                                                 "ac_kernel": (1, 1)})
    nf = len(freqs)
    node = cc.netlist.nodes["n31"]
    if xr.shape != (main_lanes, nf, cc.np1) or not bool(
            torch.isfinite(xr).all() & torch.isfinite(xi).all()) or not bool(
                opr.converged.all()):
        fail("lc31_ac_8192: wrong shape, a value not finite, or a bias not "
             "converged")
    mag = torch.sqrt(xr[:, :, node] ** 2 + xi[:, :, node] ** 2)
    if not bool(((mag[:, 0] - 0.5).abs() < 1e-4).all()):
        fail("lc31_ac_8192: |V(n31)| at 10 kHz is not half the source")
    ac_wide = ac_vs_plain("lc31_ac_8192 AC kernel", cc, params, axes, state0,
                          freqs, (xr, xi), chunk=4096 // nf)
    ac_wide.update(launches=got["ac_kernel"], wall=wall)
    phase("32 lc31_ac_8192 main path", t0,
          f"lc31 (np1={cc.np1}), {main_lanes} lanes: engine {fn.engine} "
          f"({fn.engine_reason}), stamped-solve launches="
          f"{got['stamped_solve']}, AC kernel launches={got['ac_kernel']} "
          f"for {ac_wide['systems']} systems of {ac_wide['n2']} "
          f"({ac_body(ac_wide['n2'])}), no GJ launch, wall={wall:.6f} s, "
          f"{ac_wide['systems'] / wall:.6e} systems/s on {smi}; |V(n31)| "
          f"{float(mag[:, 0].mean()):.6f} at 10 kHz; AC kernel "
          f"{ac_wide['k_ms']:.3f} ms, plain {ac_wide['p_ms']:.1f} ms in "
          f"chunks of {4096 // nf} instances, bit-identical, max abs err "
          f"{ac_wide['err']:.3e}; torch.linalg.solve "
          f"{ac_wide['lib_ms']:.3f} ms (same chunks)")
    del xr, xi, opr, mag
    free()

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(lc_ladder(31), c_spread, lanes)
    with override("TOYSPICE_AC", "general"):
        fn = make_ac_batch(cc, axes)
        if fn.engine != "general":
            fail(f"lc31 under TOYSPICE_AC=general: engine {fn.engine!r}")
        small = {k_: {kk: (v[:8] if v.ndim == 2 else v)
                      for kk, v in t.items()} for k_, t in params.items()}
        fn(small, state0, freqs)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        w0 = time.perf_counter()
        xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    got = counts()
    check_counts("lc31 AC past 128", got, {"stamped_solve": (1, 1),
                                            "gj_kernel": (1, 1)})
    if xr.shape != (lanes, nf, cc.np1) or not bool(
            torch.isfinite(xr).all() & torch.isfinite(xi).all()) or not bool(
                opr.converged.all()):
        fail("lc31 AC: wrong shape, a value not finite, or a bias not "
             "converged")
    mag = torch.sqrt(xr[:, :, node] ** 2 + xi[:, :, node] ** 2)
    if not bool(((mag[:, 0] - 0.5).abs() < 1e-4).all()):
        fail("lc31 AC: |V(n31)| at 10 kHz is not half the source")
    gk = TimedSolve(solve.linear_solve)
    sk = TimedSolve(solve_stamped.solve_lanes)
    kr, ki, kop = make_ac(cc, solve=sk, dense_solve=gk)(params, state0,
                                                        freqs)
    gp = TimedSolve(chunked(solve.gj_plain, 4096))
    pr, pi, pop = make_ac(cc, solve=solve_stamped.solve_plain,
                          dense_solve=gp)(params, state0, freqs)
    if not (torch.equal(kop.converged, pop.converged)
            and torch.equal(kop.stage, pop.stage)):
        fail("lc31 AC: the bias's converged or stage differs between the "
             "kernels and the plain versions")
    pairs = [("bias x", kop.x, pop.x), ("xr", kr, pr), ("xi", ki, pi),
             ("main xr", xr, pr), ("main xi", xi, pi)]
    ac_err = max_err("lc31 AC kernels vs plain", pairs)
    if not all(same_bits(a, b) for _, a, b in pairs):
        fail("lc31 AC: the kernels' x is not bit-identical to the plain "
             "versions'")
    a2, b2 = gk.args[0]
    del xr, xi, kr, ki, pr, pi
    free()
    _, k2_ms = timed_call(solve.launch_gj, a2, b2)
    torch.linalg.solve(a2[:1024], b2[:1024])  # warm-up
    _, lib_ms = timed_call(torch.linalg.solve, a2, b2)
    nsys = a2.shape[0]
    gj_big = dict(launches=got["gj_kernel"], err=ac_err, k_ms=k2_ms,
                  path_ms=gk.ms(), p_ms=gp.ms(), lib_ms=lib_ms,
                  systems=nsys, n=a2.shape[1],
                  flops=nsys * lu_flops(a2.shape[1]),
                  nbytes=nbytes(a2, b2) + nbytes(b2))
    phase("32 lc31 AC past 128", t0,
          f"lc31 (np1={cc.np1}), {lanes} lanes under TOYSPICE_AC=general: "
          f"engine {fn.engine} ({fn.engine_reason}), "
          f"stamped-solve launches={got['stamped_solve']}, GJ kernel "
          f"launches={got['gj_kernel']} for {nsys} systems of "
          f"{a2.shape[1]} ({solve.body(a2.shape[1])}), wall={wall:.6f} s, "
          f"{nsys / wall:.6e} systems/s on {smi}; |V(n31)| "
          f"{float(mag[:, 0].mean()):.6f} at 10 kHz; the kernels vs their "
          f"plain versions on these lanes: converged and stage equal, "
          f"bit-identical, max abs err {ac_err:.3e}; GJ kernel "
          f"{k2_ms:.3f} ms (in the path {gj_big['path_ms']:.3f} ms), plain "
          f"{gj_big['p_ms']:.1f} ms in chunks of 4096; torch.linalg.solve "
          f"{lib_ms:.3f} ms")
    del a2, b2, gk, sk, gp
    free()
    return st_big, gj_big, ac_wide


# ------------------------------------------------ 33 the user surface

SURFACE_DECKS = ("divider_op.cir", "ce_amplifier_op.cir",
                 "diode_iv_sweep.cir", "ce_amplifier_ac.cir",
                 "rc_lowpass_tran.cir", "half_wave_rectifier.cir")
# the decks whose general engine seeds its OP (or solves its AC systems)
# with the GJ kernel: a nonlinear OP, and AC
GJ_DECKS = ("ce_amplifier_op.cir", "ce_amplifier_ac.cir",
            "half_wave_rectifier.cir")
CLI_DECK = "half_wave_rectifier.cir"


class Recorder:
    """A plain solve put in its module's place: it keeps a copy of every
    call's arguments and its result."""

    def __init__(self, fn):
        self.fn, self.args, self.outs = fn, [], []

    def __call__(self, *args):
        self.args.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args))
        x = self.fn(*args)
        self.outs.append(x.clone())
        return x


def results_equal(a, b):
    return set(a) == set(b) and all(
        np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def host_reference(name, got, want=None):
    """Results against the sequential host engine's (``hostsim``, the
    reference algorithm on numpy, no code shared with the general engine;
    ``want``, or a run of it here) at tests/test_torch_hostsim.py's bars:
    the same keys and rows, within rtol 1e-9 of each series' largest
    magnitude plus atol 1e-9."""
    from toyspice_tpu_torch import hostsim

    if want is None:
        hostsim.set_solver("numpy")
        want = hostsim.run_host_analysis(
            ts.compile_circuit(ts.parse(deck_file(name))))
    if set(want) != set(got):
        fail(f"user surface {name}: keys differ from the host engine's")
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        if key.endswith("_PHASE"):
            name_ = key[:-len("_PHASE")]
            w = want[name_ + "_MAG"] * np.exp(1j * np.radians(w))
            g = got[name_ + "_MAG"] * np.exp(1j * np.radians(g))
        tol = 1e-9 + 1e-9 * float(np.abs(w).max(initial=0.0))
        if w.shape != g.shape or not bool(np.all(np.abs(g - w) <= tol)):
            fail(f"user surface {name}: {key} differs from the host "
                 f"engine's beyond {tol:.3e}")


def user_surface_phase(smi):
    """Phase 33: the single-instance API and the CLI on the card.  What is
    timed (the decks' walls, then the replayed B = 1 systems) runs with
    nothing else on the card; the CLI's process and the native build run
    beside the untimed reference pass."""
    import contextlib
    import io

    from toyspice_tpu_torch import cli, hostsim

    t0 = time.perf_counter()
    # the main path: run_analysis on the card, counts from 0
    results, walls, per_deck = {}, {}, {}
    reset_counts()
    for name in SURFACE_DECKS:
        before = counts()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        results[name] = ts.run_analysis(os.path.join(ROOT, "circuits", name))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - w0
        after = counts()
        per_deck[name] = {k: after[k] - before[k] for k in after}
        gj_want = (1, 10 ** 6) if name in GJ_DECKS else (0, 0)
        check_counts(f"user surface {name}", per_deck[name],
                     {"stamped_solve": (1, 10 ** 6), "gj_kernel": gj_want})
    got = counts()
    launches = {"stamped": got["stamped_solve"], "gj": got["gj_kernel"]}
    for name in SURFACE_DECKS:
        if not all(np.isfinite(v).all() for v in results[name].values()):
            fail(f"user surface {name}: a non-finite value")

    # the host engines' sparse LU (make -C native) in a thread, and the CLI
    # in a process of its own, beside the reference pass below
    maker = concurrent.futures.ThreadPoolExecutor(1)
    made = maker.submit(native.available)
    env = {k: v for k, v in os.environ.items() if k not in OVERRIDES}
    cli_t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "toyspice_tpu_torch",
         os.path.join(ROOT, "circuits", CLI_DECK)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the reference pass: the same calls on the plain versions
        # (TOYSPICE_SOLVER=xla), no launch, the same Results bit for bit,
        # so the same B = 1 systems in the same order, each kept
        rec_s = Recorder(solve_stamped.solve_plain)
        rec_g = Recorder(solve.gj_plain)
        solve_stamped.solve_plain, solve.gj_plain = rec_s, rec_g
        os.environ["TOYSPICE_SOLVER"] = "xla"
        try:
            reset_counts()
            for name in SURFACE_DECKS:
                p = ts.run_analysis(os.path.join(ROOT, "circuits", name))
                if not results_equal(results[name], p):
                    fail(f"user surface {name}: the card's Results are not "
                         "bit for bit those of the plain versions")
            check_counts("user surface under TOYSPICE_SOLVER=xla",
                         counts(), {})
        finally:
            del os.environ["TOYSPICE_SOLVER"]
            solve_stamped.solve_plain, solve.gj_plain = rec_s.fn, rec_g.fn
        if len(rec_s.args) != launches["stamped"] or len(
                rec_g.args) != launches["gj"]:
            fail("user surface: the plain versions solved other systems "
                 "than the kernels")

        # the CLI's host engines in this process (their Results kept: the
        # numpy engine's is CLI_DECK's reference below)
        if not made.result():
            fail(f"user surface: the native library did not build: "
                 f"{native._load_error}")
        run_host, host_runs = hostsim.run_host_analysis, []

        def kept(cc):
            host_runs.append(run_host(cc))
            return host_runs[-1]

        hostsim.run_host_analysis = kept
        try:
            for engine in ("host", "host-native"):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli.main([os.path.join(ROOT, "circuits", CLI_DECK),
                                   "--engine", engine])
                if rc != 0:
                    fail(f"user surface: the CLI with --engine {engine} "
                         f"exited {rc}")
        finally:
            hostsim.run_host_analysis = run_host
            hostsim.set_solver("numpy")
        for name in SURFACE_DECKS:
            host_reference(name, results[name],
                           host_runs[0] if name == CLI_DECK else None)

        # the CLI on the card, in the other process
        want = io.StringIO()
        cli.print_results(results[CLI_DECK], out=want)
        stdout, stderr = proc.communicate(timeout=120)
        cli_s = time.perf_counter() - cli_t0
    finally:
        maker.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        fail(f"user surface: python -m toyspice_tpu_torch exited "
             f"{proc.returncode}: {stderr[-2000:]}")
    if stdout != want.getvalue():
        fail("user surface: the CLI's tables differ from print_results of "
             "the in-process card run")

    # the kept B = 1 systems replayed, with nothing else on the card, on
    # the kernel, the plain version and torch.linalg.solve, each call
    # between CUDA events
    def replay(rec, kernel, systems, flops):
        k_ms = p_ms = l_ms = 0.0
        fl = nb = 0
        by_n = {}  # the kernel's and the plain x of each size
        for args, xp in zip(rec.args, rec.outs):
            xk, ms = timed_call(kernel, *args)
            k_ms += ms
            _, ms = timed_call(rec.fn, *args)
            p_ms += ms
            pair = by_n.setdefault(xp.shape[-1], ([], []))
            pair[0].append(xk)
            pair[1].append(xp)
            a_, b_ = systems(*args)
            _, ms = timed_call(torch.linalg.solve, a_, b_)
            l_ms += ms
            f_, b_bytes = flops(*args, xk)
            fl += f_
            nb += b_bytes
        pairs = [("x", torch.cat(k), torch.cat(p)) for k, p in by_n.values()]
        err = exact_err(f"user surface: {kernel.__name__} at B = 1", pairs)
        return dict(k_ms=k_ms, p_ms=p_ms, lib_ms=l_ms, err=err, flops=fl,
                    nbytes=nb, calls=len(rec.args))

    def st_flops(pat, vals, rvals, gmin, x):
        return (vals.shape[0] * stamped_flops(pat),
                nbytes(vals, rvals, gmin, x) + pat.table.nbytes)

    def gj_flops(a, b, x):
        return a.shape[0] * lu_flops(a.shape[1]), nbytes(a, b, x)

    torch.linalg.solve(*stamped_systems(*rec_s.args[0]))  # warm-up
    st1 = replay(rec_s, solve_stamped.launch_stamped, stamped_systems,
                 st_flops)
    gj1 = replay(rec_g, solve.launch_gj, lambda a, b: (a, b[..., None]),
                 gj_flops)
    st1["launches"], gj1["launches"] = launches["stamped"], launches["gj"]
    sizes = sorted({args[0].n for args in rec_s.args})
    deck_walls = ", ".join(
        f"{n[:-4]} {walls[n]:.6f} s ({per_deck[n]['stamped_solve']} "
        f"stamped, {per_deck[n]['gj_kernel']} GJ)" for n in SURFACE_DECKS)
    print(f"[33 single instance] {smi}: {deck_walls}; stamped solve at "
          f"B = 1 (n in {sizes}): {st1['calls']} launches, kernel "
          f"{st1['k_ms'] / st1['calls']:.6f} ms a launch, plain "
          f"{st1['p_ms'] / st1['calls']:.6f}, torch.linalg.solve on the same "
          f"B = 1 systems {st1['lib_ms'] / st1['calls']:.6f}; GJ: "
          f"{gj1['calls']} launches, kernel "
          f"{gj1['k_ms'] / gj1['calls']:.6f} ms a launch, plain "
          f"{gj1['p_ms'] / gj1['calls']:.6f}, torch.linalg.solve "
          f"{gj1['lib_ms'] / gj1['calls']:.6f} (walls and replays with "
          f"nothing else on the card); the CLI's process {cli_s:.3f} s from "
          f"start to exit", flush=True)
    phase("33 user surface", t0,
          f"run_analysis on the card on {len(SURFACE_DECKS)} decks "
          f"({launches['stamped']} stamped and {launches['gj']} GJ "
          f"launches, each deck's Results within the host engine's bars), "
          f"bit for bit with TOYSPICE_SOLVER=xla (no launch); the B = 1 "
          f"kernels bit for bit with their plain versions; python -m "
          f"toyspice_tpu_torch {CLI_DECK} exited 0 with the in-process "
          f"tables; --engine host and host-native exited 0")
    return st1, gj1


MESH_SHARDS = 4


def on_card(home, *shape):
    """A mesh of ``shape`` shards, all on the device ``home`` (several
    shards on one card run in turn): axes "data" and, for a 2-D shape,
    "sweep"."""
    devs = np.empty(shape, dtype=object)
    devs[...] = home
    return mesh.Mesh(devs, ("data", "sweep")[:len(shape)])


def leaves(tree):
    """The tensors of a result (tensors, dicts, tuples, None) in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return []


def same_tree(a, b):
    """Equal structure, shapes and dtypes, and equal bits leaf by leaf."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and (
            same_bits(x, y) if x.is_floating_point() else torch.equal(x, y))
        for x, y in zip(la, lb))


def walled(fn):
    """(result, wall s, launch counts) of fn(), the counts set to 0 just
    before and read just after."""
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - w0, counts()


def check_sharded(name, got, want, home):
    """A sharded result: every leaf on ``home`` and equal bit for bit to
    the unsharded run."""
    if not all(x.device == home for x in leaves(got)):
        fail(f"34 {name}: a sharded result is not on {home}")
    if not same_tree(got, want):
        fail(f"34 {name}: the sharded result is not bit for bit the "
             "unsharded one")


def mesh_phase(smi, bench_none, bench_wall, bench_overrides, lanes):
    """Phase 34: the sharded analyses (parallel/mesh.py) on the card, each
    held bit for bit to the unsharded run of the same inputs, with the
    launches each shard implies; the store and the general engine at
    ``lanes`` lanes."""
    t0 = time.perf_counter()
    n = MESH_SHARDS
    home = mesh.make_mesh(1, device=DEVICE).first()
    # bench_rlc_8192, the main path: one device, then four shards
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, bench_overrides(cc, BENCH_LANES))
    want_total = int(bench_none.accepted.sum())
    walls = {}
    for label, m in (("make_mesh(1)", mesh.make_mesh(1, device=DEVICE)),
                     (f"{n} shards on {home}", on_card(home, n))):
        (out, total), walls[label], got = walled(
            lambda: mesh.run_transient_sharded(cc, cfg, m, params, axes))
        check_counts(f"34 bench_rlc {label}", got,
                     {"run_kernel": (m.size, m.size)})
        check_sharded(f"bench_rlc {label}", out, bench_none, home)
        if mesh.run_transient_sharded.last_engine != "run":
            fail(f"34 bench_rlc {label}: engine "
                 f"{mesh.run_transient_sharded.last_engine!r}")
        if total.dtype != torch.int64 or int(total) != want_total:
            fail(f"34 bench_rlc {label}: total {int(total)}, phase 4's "
                 f"accepted sum {want_total}")
    del out
    cards = torch.cuda.device_count()
    if cards > 1:
        (out, total), walls[f"make_mesh({cards})"], got = walled(
            lambda: mesh.run_transient_sharded(
                cc, cfg, mesh.make_mesh(cards), params, axes))
        check_counts("34 bench_rlc across cards", got,
                     {"run_kernel": (cards, cards)})
        if not same_tree(out, bench_none) or int(total) != want_total:
            fail("34 bench_rlc across cards differs from phase 4")
        across = f"make_mesh({cards}) across the cards bit for bit"
        del out
    else:
        across = (f"make_mesh(count) across cards not run: {cards} device "
                  "on this machine")
    phase("34 sharded mesh", t0,
          f"bench_rlc_8192: {BENCH_LANES} lanes, total accepted "
          f"{want_total} (phase 4's sum), bit for bit with phase 4, one "
          "run-kernel launch a shard; wall unsharded (phase 4) "
          f"{bench_wall:.6f} s, " + ", ".join(
              f"{k} {v:.6f} s" for k, v in walls.items())
          + f"; {across}; on {smi}")

    def pair(name, deck, ov, b, unsharded, sharded, want, per_shard):
        """The unsharded run (after a warm-up), then the sharded one, bit
        for bit, each with its launches counted."""
        t1 = time.perf_counter()
        cc_, cfg_, params_, axes_, _ = setup(deck, ov, b)
        unsharded(cc_, cfg_, params_, axes_)  # warm-up
        free()
        want_r, u_wall, u_got = walled(lambda: unsharded(cc_, cfg_, params_,
                                                         axes_))
        check_counts(f"34 {name} unsharded", u_got, want)
        got_r, s_wall, s_got = walled(lambda: sharded(cc_, cfg_, params_,
                                                      axes_))
        # each shard launches at least what a run launches at least, and
        # no more than the whole batch did (its lanes are a subset)
        check_counts(f"34 {name} sharded", s_got, {
            k: (lo * per_shard, u_got[k] * per_shard)
            for k, (lo, _) in want.items()})
        check_sharded(name, got_r, want_r, home)
        phase("34 sharded mesh", t1,
              f"{name}: {b} lanes, {per_shard} shards on {home}, bit "
              "for bit with the unsharded run; launches unsharded "
              + ", ".join(f"{k} {c}" for k, c in u_got.items() if c)
              + ", sharded "
              + ", ".join(f"{k} {c}" for k, c in s_got.items() if c)
              + f"; wall unsharded {u_wall:.6f} s, sharded {s_wall:.6f} s "
              f"on {smi}")
        return got_r, want_r

    op_mesh, ac_mesh = on_card(home, n), on_card(home, 2, 2)
    hwr = deck_file("half_wave_rectifier.cir")
    op_u, _ = pair(
        "half_wave_rectifier OP (the OP kernel)", hwr, rc_spread,
        BENCH_LANES, lambda c, f, p, a: ts.run_op_batch(c, p, a),
        lambda c, f, p, a: mesh.run_op_sharded(c, op_mesh, p, a),
        {"op_kernel": (1, 1 << 30)}, n)
    if not bool(op_u.converged.all()) or \
            mesh.run_op_sharded.last_engine != "fused":
        fail("34 rectifier OP: a lane did not converge or the engine is "
             f"{mesh.run_op_sharded.last_engine!r}")

    def dc_args(c):
        d = c.netlist.dc
        return ((c.names["V"].index(d.source1),),
                np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1)))

    (xs, conv), _ = pair(
        "diode_iv_sweep (the DC sweep kernel)",
        deck_file("diode_iv_sweep.cir"), rsen_is, BENCH_LANES,
        lambda c, f, p, a: ts.run_dc_batch(c, dc_args(c)[0], p, a,
                                           dc_args(c)[1]),
        lambda c, f, p, a: mesh.run_dc_sharded(c, dc_args(c)[0], op_mesh,
                                               p, a, dc_args(c)[1]),
        {"dc_sweep_kernel": (1, 1)}, n)
    if not bool(conv.all()) or mesh.run_dc_sharded.last_engine != "fused":
        fail("34 DC sweep: a point did not converge or the engine is "
             f"{mesh.run_dc_sharded.last_engine!r}")
    del xs, conv

    def ac_runs(m):
        def freqs(c):
            a = c.netlist.ac
            return ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)
        return (lambda c, f, p, a: ts.run_ac_batch(c, p, a, freqs(c)),
                lambda c, f, p, a: mesh.run_ac_sharded(c, m, p, a,
                                                       freqs(c)))

    pair("ce_amplifier_ac (the OP and AC kernels), a (2, 2) mesh",
         deck_file("ce_amplifier_ac.cir"), rc_spread, BENCH_LANES,
         *ac_runs(ac_mesh), {"op_kernel": (1, 1 << 30),
                             "ac_kernel": (1, 1)}, 4)
    free()
    # lc16's 21 frequencies do not split over 2 columns: a (2, 3) mesh
    pair("lc16_ac_8192 (the stamped solve and the AC kernel), a (2, 3) "
         "mesh", lc_ladder(16), c_spread, BENCH_LANES,
         *ac_runs(on_card(home, 2, 3)),
         {"stamped_solve": (1, 1), "ac_kernel": (1, 1)}, 6)
    free()

    def store_runs(c, f, p, a):
        return ts.make_tran_batch(c, f, a, store="full")(
            p, ts.init_state(c))

    pair("half_wave_rectifier store='full' (the OP and store kernels)", hwr,
         rc_spread, lanes, store_runs,
         lambda c, f, p, a: mesh.run_transient_sharded(
             c, f, op_mesh, p, a, store="full")[0],
         {"op_kernel": (1, 1 << 30), "run_kernel_store": (1, 1)}, n)
    free()
    for engine, label, want in (
            ("run", "the run kernel's block bucket",
             {"run_kernel": (1, 1)}),
            ("general", "TOYSPICE_TRAN=general: the general engine, the "
             "stamped wide body", {"stamped_solve": (1, 1 << 30)})):
        if engine == "general":
            os.environ["TOYSPICE_TRAN"] = "general"
        try:
            pair(f"rc127_1024 ({label})", rc_ladder(127), c_spread, lanes,
                 lambda c, f, p, a: ts.make_tran_batch(c, f, a)(
                     p, ts.init_state(c)),
                 lambda c, f, p, a: mesh.run_transient_sharded(
                     c, f, op_mesh, p, a)[0], want, n)
        finally:
            os.environ.pop("TOYSPICE_TRAN", None)
        if mesh.run_transient_sharded.last_engine != engine:
            fail("34 rc127: engine "
                 f"{mesh.run_transient_sharded.last_engine!r}, expected "
                 f"{engine!r}")
        free()

    t1 = time.perf_counter()
    _, d_wall, got = walled(lambda: dryrun.dryrun_multichip(
        cards, device=DEVICE))
    want = {"run_kernel": (cards, cards), "op_kernel": (cards, 1 << 30),
            "dc_sweep_kernel": (cards, cards)}
    if cards % 2 == 0:
        want.update(ac_kernel=(cards, cards), stamped_solve=(cards, cards))
    check_counts("34 dryrun_multichip", got, want)
    phase("34 sharded mesh", t1,
          f"dryrun_multichip({cards}) passed, wall {d_wall:.6f} s; launches "
          + ", ".join(f"{k} {c}" for k, c in got.items() if c))
    phase("34 sharded mesh", t0, "every sharded run bit for bit with its "
          "unsharded one")


# ---------------------------------------------------- past the former caps
# Decks past the kernels' former caps (more than 32 sources, a stamp plan
# past the 48 KB table; tests/test_torch_past_caps.py keeps the same).


def nmos_ring(stages, tstop="500n"):
    """A resistor-load NMOS ring oscillator of ``stages`` inverters (odd),
    kicked by a current pulse into n0; np1 = stages + 3."""
    lines = [f"* {stages}-stage NMOS ring oscillator", f".tran 1n {tstop} uic",
             "VDD vdd 0 DC 5", "IK n0 0 PULSE(0 200u 0 1n 1n 5n 1)"]
    for i in range(stages):
        out = f"n{(i + 1) % stages}"
        lines += [f"RP{i} vdd {out} 10k", f"MN{i} {out} n{i} 0 0 NSW",
                  f"CL{i} {out} 0 1p"]
    lines.append(".model NSW NMOS (VTO=1.1 KP=3m LAMBDA=0.01)")
    return "\n".join(lines) + "\n"


def cmos_ring(stages, tstop="2n"):
    """A level-1 CMOS ring of ``stages`` inverters (odd), 5 fF loads,
    kicked by a current pulse into n0; np1 = stages + 3."""
    lines = ["* ring", f".tran 10p {tstop}", "VDD vdd 0 DC 1.8",
             "IK n0 0 PULSE(0 100u 0 50p 50p 100p 1)"]
    for i in range(stages):
        out = f"n{(i + 1) % stages}"
        lines += [f"MP{i} {out} n{i} vdd vdd PM W=2u L=0.18u",
                  f"MN{i} {out} n{i} 0 0 NM W=1u L=0.18u",
                  f"CL{i} {out} 0 5f"]
    lines += [".model NM NMOS(LEVEL=1 VTO=0.5 KP=200u)",
              ".model PM PMOS(LEVEL=1 VTO=-0.5 KP=80u)"]
    return "\n".join(lines) + "\n"


def pv_module(cells, bypass=24, points=".dc VLOAD 0 60 0.5"):
    """``cells`` PV cells in series (a photocurrent, a diode and a shunt
    each), a bypass diode across every ``bypass`` cells, a series
    resistance into the swept load source; np1 = cells + 3."""
    lines = [f"* {cells}-cell PV module", points]
    for i in range(cells):
        a, b = ("0" if i == 0 else f"c{i}"), f"c{i + 1}"
        lines += [f"IPH{i} {b} {a} DC 8.5", f"D{i} {b} {a} DCELL",
                  f"RSH{i} {b} {a} 250"]
    for k in range(cells // bypass):
        a = "0" if k == 0 else f"c{k * bypass}"
        lines.append(f"DB{k} {a} c{(k + 1) * bypass} DBYP")
    lines += [f"RS c{cells} out 0.3", "VLOAD out 0 DC 0",
              ".model DCELL D(IS=1e-10 N=1.2)",
              ".model DBYP D(IS=1e-8 N=1.0)"]
    return "\n".join(lines) + "\n"


def bus(count, tstop="10n"):
    """A parallel bus of ``count`` RC lines, each driven by its own PULSE
    source through 50 ohm, neighbours coupled by 0.2 pF; np1 = 3 count +
    1."""
    lines = [f"* {count}-line coupled bus", f".tran 0.05n {tstop}"]
    for i in range(count):
        lines += [f"V{i} d{i} 0 PULSE(0 1 {0.1 * i:.1f}n 0.1n 0.1n 2n 5n)",
                  f"R{i} d{i} l{i} 50", f"C{i} l{i} 0 1p"]
        if i:
            lines.append(f"CC{i} l{i - 1} l{i} 0.2p")
    return "\n".join(lines) + "\n"


def many_sources(count, np1):
    """``count`` DC current sources spread over the nodes of an RC ladder
    of np1 - 2 nodes from a SIN source (np1 unknowns)."""
    nodes = np1 - 2
    lines = [f"* {count} sources, np1 = {np1}", ".tran 0.01m 0.2m",
             "Vin 1 0 SIN(0 1 5k)"]
    for k in range(1, nodes):
        lines += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 10n"]
    lines.append(f"R{nodes} {nodes} 0 1k")
    lines += [f"I{k} 0 {k % nodes + 1} DC {0.01 * (k % 7 + 1):.2f}m"
              for k in range(count)]
    return "\n".join(lines) + "\n"


def resistor_bank(count):
    """``count`` resistors in parallel into a capacitor (np1 = 4): past
    about 1,650 the stamp plan alone outgrows a block's shared memory."""
    lines = ["* resistor bank", ".tran 0.01m 0.2m", "Vin 1 0 SIN(0 1 5k)",
             "C1 2 0 1u"]
    lines += [f"R{k} 1 2 {1e3 * count * (1 + k % 3)}" for k in range(count)]
    return "\n".join(lines) + "\n"


def diode_bank(count):
    """``count`` diodes in parallel behind 1 kohm (np1 = 4)."""
    lines = ["* diode bank", ".tran 0.01m 1m", "V1 1 0 DC 5", "R1 1 2 1k"]
    lines += [f"D{k} 2 0 DM" for k in range(count)]
    lines += [".model DM D (Is=1e-14)"]
    return "\n".join(lines) + "\n"


def coupled_sources(count):
    """circuits/coupled_inductors.cir's transformer with ``count`` DC
    current sources into its secondary's load (K beside > 32 sources)."""
    lines = ["* transformer with many sources", ".tran 5u 0.2m",
             "Vpri in 0 SIN(0 10 2k)", "Rpri in p1 4.7", "Lp p1 0 8m",
             "Ls s1 0 2m", "K1 Lp Ls 0.995", "Rsec s1 0 150"]
    lines += [f"I{k} 0 s1 DC {0.1 * (k % 5 + 1):.1f}m" for k in range(count)]
    return "\n".join(lines) + "\n"


# phase 38's cells: the NMOS ring's tstop (cut if its run launch takes
# more than 20 s), the bus's and the PV module's sweep
NMOS_TSTOP = "100n"
BUS_TSTOP = "10n"
# the spans (s) over which the two transient cells' 259 lanes are held to
# run_plain and to the general engine
NMOS_SPAN, BUS_SPAN = 1e-9, 0.1e-9
PV_POINTS = (0.0, 60.0, 0.5)
# what the CPU tests hold to the JAX package's general engine on these
# cells' seeded lanes, and chip_smoke holds the card to: the NMOS ring's
# one lane whose node leaves the rails (its n53 alternates step by step
# between the rails and -1 / LAMBDA from 10.7 ns; held over NMOS_HOLD s,
# tests/test_torch_past_caps_ring.py), and the PV module's one point that
# does not converge (the JAX package's sweep does not converge there
# either; tests/test_torch_past_caps_pv.py): (lane, point)
NMOS_OFF_RAILS = [337]
NMOS_HOLD = 15e-9
PV_UNCONVERGED = [(6232, 36)]

# phase 38's run flavours at 259 lanes: (group, name, deck, semantics,
# trap, attempts, (bucket, table in shared memory, slice in shared
# memory)), each through make_tran_batch and bit for bit against run_plain,
# both over at most ``attempts`` attempts
BB = run.BLOCK_BUCKET
PAST_CAPS_RUNS = (
    ("sources", "sources33_np1_4", many_sources(33, 4), "compat", False,
     100, (4, True, True)),
    ("sources", "sources40_np1_6", many_sources(40, 6), "compat", False, 100,
     (8, True, True)),
    ("sources", "sources40_np1_14", many_sources(40, 14), "compat", False,
     100, (16, True, True)),
    ("sources", "sources40_np1_30", many_sources(40, 30), "compat", False,
     100, (32, True, True)),
    ("sources", "sources40_np1_50", many_sources(40, 50), "compat", False,
     100, (64, True, True)),
    ("physics", "physics_trap_sources40_np1_14", many_sources(40, 14),
     "physics", True, 100, (16, True, True)),
    ("magnetic", "magnetic_sources33", coupled_sources(33), "compat", False,
     100, (8, True, True)),
    ("physics_magnetic", "physics_magnetic_sources33", coupled_sources(33),
     "physics", True, 100, (8, True, True)),
    ("table", "resistor_bank1700", resistor_bank(1700), "compat", False, 3,
     (64, False, True)),
    ("table", "diode_bank2100", diode_bank(2100), "compat", False, 3,
     (64, False, True)),
    ("table", "cmos_ring101", cmos_ring(101, "30p uic"), "compat", False, 2,
     (BB, False, True)),
    ("table", "cmos_ring151", cmos_ring(151, "30p uic"), "compat", False, 2,
     (BB, False, False)))

# phase 38's OP and DC sweep flavours at 259 lanes: (name, deck, kind,
# placement)
PAST_CAPS_OPDC = (
    ("op_diode_bank2100", diode_bank(2100), "op", (64, False, True)),
    ("dc_diode_bank2100", diode_bank(2100), "dc", (64, False, True)),
    ("op_cmos_ring151", cmos_ring(151), "op", (BB, True, False)))


def pv_spread(cc, b):
    """R spread 0.1 and the photocurrents (the I sources' dc) spread 0.1,
    numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    ov = perturbed(cc, rng, b, ("R",))
    dc_ = np.asarray(cc.params["I"]["dc"])
    ov["I"] = {"dc": dc_[None] * np.exp(rng.normal(0.0, 0.1,
                                                   (b, len(dc_))))}
    return ov


def src_spread(cc, b):
    """R and C spread 0.1, then the I sources' dc (when there are)."""
    ov = rc_spread(cc, b)
    if "I" in cc.params:
        rng = np.random.default_rng(1)
        dc_ = np.asarray(cc.params["I"]["dc"])
        ov["I"] = {"dc": dc_[None] * np.exp(rng.normal(0.0, 0.1,
                                                       (b, len(dc_))))}
    return ov


def tran_vs(name, a, b):
    """Counters equal per lane, t_final, state and jv within RTOL: one
    TranOutput against another (the general engine's)."""
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        if not torch.equal(getattr(a, key), getattr(b, key)):
            bad = int((getattr(a, key) != getattr(b, key)).sum())
            fail(f"{name}: {key} differs on {bad} lanes")
    return max_err(name, [("t_final", a.t_final, b.t_final)] + [
        (f"{what}.{kd}.{key}", at[kd][key], bt[kd][key])
        for what, at, bt in (("state", a.state, b.state), ("jv", a.jv, b.jv))
        for kd in bt for key in bt[kd]])


def lanes_of(params, axes, lanes):
    """The lanes ``lanes`` (a count: the first ones; or an index tensor) of
    a batch's parameters: its batched leaves (axis 0 in ``axes``) cut, the
    shared ones as they are."""
    pick = slice(lanes) if isinstance(lanes, int) else lanes
    return {k: {kk: (v[pick] if axes[k][kk] == 0 else v)
                for kk, v in t.items()} for k, t in params.items()}


def placed(what, got, want):
    if got != want:
        fail(f"{what}: placement {got}, expected {want}")


def op_bound(plan, ko, lanes, launches):
    """An OP's operations (every Newton iteration's, the linear estimate of
    every lane) and bytes (each launch's rows and table)."""
    return (int(ko.iters_all.sum()) * newton_flops(plan) + lanes * (
        build_flops(plan, plan.entries[:plan.n_lin]) + lu_flops(plan.np1)),
        launches * (lanes * (8 * (plan.nd + op.dyn_width(plan)
                                  + 2 * (plan.np1 + plan.kj)) + 8)
                    + plan.topo.nbytes))


def dc_bound(plan, kd, dev, dyn, vs, lanes, points):
    """A sweep's operations (every point's Newton iterations) and bytes."""
    per_it = newton_flops(plan) - (plan.np1 - 1)
    return (int(int(kd.iters.sum()) * per_it),
            nbytes(dev, dyn, vs, kd.xs) + plan.topo.nbytes
            + lanes * points * 8)


def op_vs_plain(name, cc, params, state0, semantics="compat"):
    """The OP through make_op_fused on the kernel and on op_plain, timed
    per launch: bit for bit; (kernel result, max abs err, kernel ms, plain
    ms, plan, kernel launches)."""
    tk, tp_ = TimedSolve(op.op_lanes), TimedSolve(op.op_plain)
    ko = op.make_op_fused(cc, DEFAULTS, semantics, solve=tk)(params, state0)
    po = op.make_op_fused(cc, DEFAULTS, semantics, solve=tp_)(params, state0)
    for key in ("converged", "stage", "iters", "iters_all"):
        if not torch.equal(getattr(ko, key), getattr(po, key)):
            fail(f"{name}: {key} differs between the kernel and op_plain")
    err = exact_err(name, [("x", ko.x, po.x)] + [
        (f"jv.{kd}.{key}", ko.jv[kd][key], po.jv[kd][key])
        for kd in po.jv for key in po.jv[kd]])
    return ko, err, tk.ms(), tp_.ms(), tk.args[0][0], len(tk.events)


def dc_vs_plain(name, cc, params, state0, pts):
    """The sweep through make_dc_fused on the kernel and on dc_plain:
    bit for bit; (kernel result, max abs err, kernel ms, plain ms, the
    kernel's arguments)."""
    tk, tp_ = TimedSolve(dc.dc_lanes), TimedSolve(dc.dc_plain)
    kd = dc.make_dc_fused(cc, (0,), DEFAULTS, solve=tk)(params, state0, pts)
    pd = dc.make_dc_fused(cc, (0,), DEFAULTS, solve=tp_)(params, state0, pts)
    for key in ("conv", "iters"):
        if not torch.equal(getattr(kd, key), getattr(pd, key)):
            fail(f"{name}: {key} differs from dc_plain")
    n = cc.np1
    err = exact_err(name, [("xs", kd.xs.reshape(-1, n),
                            pd.xs.reshape(-1, n))])
    return kd, err, tk.ms(), tp_.ms(), tk.args[0]


def tran_cell(label, deck, ov, main_lanes, lanes, span, smi, check,
              hold=None):
    """One transient cell: make_tran_batch at ``main_lanes`` lanes (the
    counts set to 0 just before: one run launch) between CUDA events,
    ``check`` on its output (it fails, or describes it and names the lanes
    it found off the rails: those the kernel then runs against run_plain
    over the first ``hold`` seconds); the kernel against run_plain on
    ``lanes`` of its lanes over the first ``span`` seconds; the general
    engine (TOYSPICE_TRAN=general) against the run engine on those lanes
    over that span.  Returns the cell's numbers."""
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(deck, ov, main_lanes)
    ts.make_tran_batch(cc, cfg._replace(tstop=cfg.tstop / 50), axes)(
        params, state0)  # warm-up
    fn = ts.make_tran_batch(cc, cfg, axes)
    if fn.engine != "run":
        fail(f"{label}: engine {fn.engine!r} ({fn.engine_reason})")
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out, main_ms = timed_call(fn, params, state0)  # the launch and its host
    wall = time.perf_counter() - w0
    got = counts()
    check_counts(f"{label} main path", got, {"run_kernel": (1, 1)})
    failed = int(out.fail.sum())
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"{label}: {failed} lanes failed or stopped early")
    checked, past = check(cc, out)
    plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
    shape = run.segment_shape(plan, main_lanes)
    main_flops = run_bound(plan, out, False)
    main_bytes = run_nbytes(plan, dev, src, st, jv0, main_lanes)
    accepted, attempts = int(out.accepted.sum()), int(out.attempts.sum())
    if past:  # the kernel and the plain over the first `hold` seconds
        idx = torch.as_tensor(past, device=dev.device)
        cut = [x[idx] for x in (dev, src, st)]
        jc = None if jv0 is None else jv0[idx]
        ko, _, po, _ = kernel_vs_plain(plan, *cut, sc._replace(tstop=hold),
                                       jc)
        compare_run(f"{label} lanes {past} vs plain", ko, po,
                    check_jv=jc is not None)
        checked += (f" (lanes {past}: the kernel bit for bit with run_plain "
                    f"over the first {hold:g} s)")
        del ko, po
    del out
    free()
    # the kernel against its plain version on `lanes` lanes, first `span`
    short = cfg._replace(tstop=span)
    scs = sc._replace(tstop=span)
    cut = [x[:lanes] for x in (dev, src, st)]
    kc, kc_ms, pc, pc_ms = kernel_vs_plain(plan, *cut, scs)
    err = compare_run(f"{label} vs plain", kc, pc)
    res = dict(launches=got["run_kernel"], err=err, k_ms=kc_ms, p_ms=pc_ms,
               flops=run_bound(plan, kc, False),
               nbytes=run_nbytes(plan, *cut, None, lanes), main_ms=main_ms,
               main_flops=main_flops, main_bytes=main_bytes, wall=wall,
               accepted=accepted, shape=shape)
    del kc, pc
    # the general engine on those lanes over that span
    sub = lanes_of(params, axes, lanes)
    fk = ts.make_tran_batch(cc, short, axes)
    kr = fk(sub, state0)
    with override("TOYSPICE_TRAN", "general"):
        fg = ts.make_tran_batch(cc, short, axes)
    if fg.engine != "general":
        fail(f"{label} under TOYSPICE_TRAN=general: engine {fg.engine!r}")
    g = fg(sub, state0)
    torch.cuda.synchronize()
    res["gen_err"] = tran_vs(f"{label} general engine vs run kernel", kr, g)
    res["gen_accepted"] = int(g.accepted.sum())
    mb = bound(main_flops, main_bytes)
    phase(f"38 {label} main path", t0,
          f"{label} (np1={cc.np1}, {sum(plan.counts[5:])} D/Q/M, "
          f"{sum(len(v) for v in plan.stype.values())} sources, a table of "
          f"{plan.topo.size} words): engine={fn.engine} "
          f"({fn.engine_reason}), run kernel launches={got['run_kernel']}, "
          f"no OP, stamped or GJ launch; launch shape (the library's): "
          f"{shape[3]} threads a block, {shape[1]} lanes a block, "
          f"{shape[2]} blocks, {shape[4]} B of shared memory a block, table "
          f"in {'shared' if shape[6] else 'device'} memory, {shape[5]} "
          f"doubles a slice in device memory; lanes={main_lanes}, "
          f"accepted={accepted}, attempts={attempts}, failed=0, every lane "
          f"at tstop, {checked}; wall={wall:.6f} s, {accepted / wall:.6e} "
          f"accepted steps/s; the path between events {main_ms:.3f} ms "
          f"(the run launch and its host work), the launch's bound "
          f"{mb[0]:.6f} ms "
          f"({mb[1]}); on {lanes} of its lanes over the "
          f"first {span:g} s: kernel {kc_ms:.3f} ms, plain {pc_ms:.1f} ms, "
          f"counters equal, bit for bit, max abs err {err:.3e}; the general "
          f"engine (TOYSPICE_TRAN=general) over that span: counters equal "
          f"to the run kernel's, max abs err {res['gen_err']:.3e}; on {smi}")
    free()
    return res


def past_caps_phase(lanes, main_lanes, smi):
    """Phase 38: the run, store, OP and DC sweep kernels past their former
    caps (more than 32 sources, a stamp plan past the 48 KB table; the
    table read in device memory when it does not fit shared memory beside
    the lanes' slices).  Main paths at ``main_lanes`` lanes, each with the
    launch counts set to 0 just before and read just after:
    nmos_ring101_8192 (a 101-stage NMOS ring oscillator, np1 = 104, UIC, R
    and C spread: one run launch), bus48_8192 (48 PULSE-driven coupled
    lines, 48 sources, np1 = 145: one run launch) and pv72_iv_8192 (a
    72-cell PV module with 3 bypass diodes, 73 sources, np1 = 75, the
    photocurrents spread: its OP under the rescue ladders, then its I-V
    sweep at 121 points in one DC sweep launch); each against the general
    engine at ``lanes`` lanes (counters equal, state within rtol 1e-9) and
    its kernels bit for bit against their plain versions; the PV module's
    AC at 9 frequencies through the OP kernel's bias.  Only the ring's
    lanes NMOS_OFF_RAILS end off the rails and only the module's points
    PV_UNCONVERGED do not converge, as the JAX package's general engine
    does on those lanes (the CPU tests).  Then at ``lanes``
    lanes, through the entry points (counts reset before) and bit for bit
    against the plain versions: PAST_CAPS_RUNS (more than 32 sources in
    the 4-, 8-, 16-, 32- and 64-row buckets, under physics and with K;
    the table in device memory in the 64-row and block buckets, the
    last with the slice in shared memory and in the workspace), the
    store with its stream in 3 chunks on the bus and on the NMOS ring, and
    PAST_CAPS_OPDC.  Returns each flavour's numbers."""
    res = {}

    def nmos_check(cc, out):
        # every capacitor within the rails (by a tenth of the supply) at
        # tstop, but on the lanes NMOS_OFF_RAILS, where those past them sit
        # within 1 V of -1 / LAMBDA (the CPU test holds that lane to the
        # JAX package)
        supply = 5.0
        vc = out.state["C"]["v0"]
        lo, hi = float(vc.min()), float(vc.max())
        if not bool(torch.isfinite(vc).all()):
            fail("nmos_ring101: a capacitor's voltage is not finite")
        off = (vc < -0.1 * supply) | (vc > 1.1 * supply)
        lanes_off = torch.nonzero(off.any(dim=1)).flatten().tolist()
        if lanes_off != NMOS_OFF_RAILS:
            fail(f"nmos_ring101: lanes {lanes_off[:8]} ({len(lanes_off)}) "
                 f"end off the rails, not {NMOS_OFF_RAILS}")
        at = -1.0 / float(cc.params["M"]["lam"][0])
        if not bool(((vc[off] - at).abs() < 1.0).all()):
            fail(f"nmos_ring101: lanes {lanes_off} off the rails, not at "
                 f"-1 / LAMBDA = {at:g} V")
        return (f"the capacitors at tstop {lo:.6g} .. {hi:.6g} V, within the "
                f"rails (0 .. {supply:g} V, by a tenth) but {int(off.sum())} "
                f"on lanes {lanes_off}, at {float(vc[off].min()):.6g} V "
                f"(-1 / LAMBDA = {at:g} V)"), lanes_off

    def bus_check(cc, out):
        # the coupling capacitors hold the lines' differences, so no rail
        # bounds them: finite
        vc = out.state["C"]["v0"]
        if not bool(torch.isfinite(vc).all()):
            fail("bus48: a capacitor's voltage is not finite")
        return (f"the capacitors at tstop {float(vc.min()):.6g} .. "
                f"{float(vc.max()):.6g} V"), []

    res["nmos"] = tran_cell("nmos_ring101_8192",
                            nmos_ring(101, NMOS_TSTOP), rc_spread,
                            main_lanes, lanes, NMOS_SPAN, smi, nmos_check,
                            NMOS_HOLD)
    res["bus"] = tran_cell("bus48_8192", bus(48, BUS_TSTOP), rc_spread,
                           main_lanes, lanes, BUS_SPAN, smi, bus_check)

    # ---- pv72_iv_8192: the OP, then the sweep
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(pv_module(72), pv_spread,
                                        main_lanes)
    pts = ts.sweep_values(*PV_POINTS)
    plan_op = run.make_plan(cc, "op")
    placed("pv72 OP", run.placement(plan_op, op.lane_doubles(plan_op)),
           (BB, True, True))
    ts.run_op_batch(cc, params, axes)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    opr = ts.run_op_batch(cc, params, axes)
    torch.cuda.synchronize()
    op_wall = time.perf_counter() - w0
    xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    check_counts("pv72 main path", got, {"op_kernel": (1, 64),
                                         "dc_sweep_kernel": (1, 1)})
    # every OP converges, and every point but PV_UNCONVERGED (the JAX
    # package's sweep does not converge there either); its lane is held,
    # with the first lanes, to the plain versions and the general engine
    unconv = [tuple(p) for p in torch.nonzero(~conv).tolist()]
    if not bool(opr.converged.all()) or unconv != PV_UNCONVERGED:
        fail(f"pv72: {int((~opr.converged).sum())} OPs and the points "
             f"{unconv[:8]} ({len(unconv)}) not converged, not "
             f"{PV_UNCONVERGED}")
    held = [lane for lane, _ in unconv]
    cur = xs[:, :, cc.np1 - 1]  # the load source's branch current
    if not bool(torch.isfinite(xs[conv]).all()) or not bool(
            (cur[conv].abs() < 20.0).all()):
        fail("pv72: a converged current is not finite or past 20 A")
    i0 = float(cur[:, 0][conv[:, 0]].mean())
    i_end = float(cur[:, -1][conv[:, -1]].mean())
    # the OP and the sweep against their plain versions on `lanes` lanes
    firsts = [i for i in range(lanes) if i not in held]
    pick = torch.as_tensor(held + firsts[:lanes - len(held)],
                           device=xs.device)
    sub = lanes_of(params, axes, pick)
    ko, op_err, op_k, op_p, plan_k, op_n = op_vs_plain("pv72 OP", cc, sub,
                                                       state0)
    if not torch.equal(ko.x, opr.x[pick]):
        fail("pv72 OP: the path's x differs from make_op_fused's")
    # the sweep's points to the last one not converged (the first 9 at
    # least): a lane's points carry its junction voltages from the start,
    # so a shorter sweep gives the same first points
    cut_pts = pts[:max([9] + [point + 1 for _, point in unconv])]
    kd, dc_err, dc_k, dc_p, dc_args = dc_vs_plain("pv72 sweep", cc, sub,
                                                  state0, cut_pts)
    if not same_bits(kd.xs, xs[pick][:, :len(cut_pts)]):
        fail("pv72 sweep: the path's xs differs from make_dc_fused's")
    res["pv_op"] = dict(launches=got["op_kernel"], err=op_err, k_ms=op_k,
                        p_ms=op_p, wall=op_wall)
    res["pv_op"]["flops"], res["pv_op"]["nbytes"] = op_bound(
        plan_k, ko, lanes, op_n)
    res["pv_dc"] = dict(launches=got["dc_sweep_kernel"], err=dc_err,
                        k_ms=dc_k, p_ms=dc_p, wall=wall - op_wall)
    res["pv_dc"]["flops"], res["pv_dc"]["nbytes"] = dc_bound(
        dc_args[0], kd, *dc_args[1:4], lanes, len(cut_pts))
    # the general OP and sweep (TOYSPICE_OP=general) on those lanes
    with override("TOYSPICE_OP", "general"):
        gop = ts.run_op_batch(cc, sub, axes)
        gxs, gconv = ts.run_dc_batch(cc, (0,), sub, axes, cut_pts)
    torch.cuda.synchronize()
    if not (torch.equal(gop.converged, ko.converged)
            and torch.equal(gop.stage, ko.stage)
            and torch.equal(gconv, kd.conv)):
        fail("pv72: the general OP or sweep converges elsewhere")
    gen_err = max_err("pv72 general vs kernels", [
        ("op x", gop.x, ko.x), ("sweep xs", gxs.reshape(-1, cc.np1),
                                kd.xs.reshape(-1, cc.np1))])
    # the AC at 9 frequencies through the OP kernel's bias
    acdeck = pv_module(72, points=".ac DEC 3 1k 1meg").replace(
        "VLOAD out 0 DC 0", "VLOAD out 0 AC 1")
    acc_, _, aparams, aaxes, astate = setup(acdeck, pv_spread, lanes)
    freqs = ts.frequency_points("DEC", 1e3, 1e6, 9)
    fa = make_ac_batch(acc_, aaxes)
    if fa.engine != "fused" or fa.bias_engine != "fused":
        fail(f"pv72 AC: engines {fa.engine!r}, {fa.bias_engine!r}")
    reset_counts()
    xr, xi, aop = fa(aparams, astate, freqs)
    torch.cuda.synchronize()
    check_counts("pv72 AC path", counts(), {"op_kernel": (1, 64),
                                            "ac_kernel": (1, 1)})
    pr, pi, pop = make_ac_batch(acc_, aaxes, op_solve=op.op_plain,
                                ac_solve=ac.ac_plain)(aparams, astate, freqs)
    ac_err = exact_err("pv72 AC", [("xr", xr.reshape(-1, acc_.np1),
                                    pr.reshape(-1, acc_.np1)),
                                   ("xi", xi.reshape(-1, acc_.np1),
                                    pi.reshape(-1, acc_.np1)),
                                   ("bias x", aop.x, pop.x)])
    res["pv_op"]["err"] = max(op_err, ac_err)
    phase("38 pv72_iv_8192 main path", t0,
          f"72-cell PV module (np1={cc.np1}, 75 diodes, 73 sources): OP "
          f"kernel launches={got['op_kernel']} (the rescue ladders' rungs), "
          f"DC sweep kernel launches={got['dc_sweep_kernel']}, no stamped "
          f"or GJ launch; lanes={main_lanes} x {len(pts)} points, every OP "
          f"converged, {len(unconv)} points not ((lane, point) {unconv}, as in "
          f"the JAX package's sweep of that lane; the lane among those held "
          f"below); the load current "
          f"{i0:.6f} A at 0 V, "
          f"{i_end:.6f} A at {PV_POINTS[1]:g} V (the lanes' mean); wall "
          f"{wall:.6f} s (the OP {op_wall:.6f} s), "
          f"{main_lanes * len(pts) / (wall - op_wall):.6e} points/s; on "
          f"{lanes} lanes (those first; the sweep's first {len(cut_pts)} "
          f"points): the OP kernel vs op_plain bit for bit, "
          f"{op_n} launches, kernel {op_k:.3f} ms, plain {op_p:.1f} ms; the "
          f"sweep kernel vs dc_plain bit for bit, kernel {dc_k:.3f} ms, "
          f"plain {dc_p:.1f} ms; the general OP and sweep "
          f"(TOYSPICE_OP=general): converged equal, max abs err "
          f"{gen_err:.3e}; its AC at 9 frequencies (one OP-kernel bias, one "
          f"AC launch) bit for bit with op_plain and ac_plain, max abs err "
          f"{ac_err:.3e}; on {smi}")
    del opr, xs, ko, kd, gop, gxs, xr, xi, pr, pi
    free()

    # ---- the run flavours at `lanes` lanes
    for group, name, deck, semantics, trap, attempts, place in \
            PAST_CAPS_RUNS:
        t0 = time.perf_counter()
        opts = ts.SimOptions(integration="trap" if trap else "be")
        cc, cfg, params, axes, state0 = setup(deck, src_spread, lanes)
        cfg = cfg._replace(max_attempts=attempts)
        fn = ts.make_tran_batch(cc, cfg, axes, semantics=semantics,
                                opts=opts)
        if fn.engine != "run":
            fail(f"38 {name}: engine {fn.engine!r} ({fn.engine_reason})")
        reset_counts()
        out = fn(params, state0)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"38 {name} path", got, {
            "run_kernel": (1, 1), "op_kernel": (0, 1 << 30),
            "stamped_solve": (0, 1 << 30), "gj_kernel": (0, 1 << 30)})
        plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0,
                                                  opts, semantics)
        placed(name, run.run_placement(plan), place)
        shape = run.segment_shape(plan, lanes)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
        e = compare_run(f"38 {name}", k, p, check_jv=jv0 is not None)
        if int(k.accepted.sum()) == 0:
            fail(f"38 {name}: no lane accepted a step")
        g = res.setdefault(group, dict(launches=0, err=0.0))
        g["launches"] += got["run_kernel"]
        g["err"] = max(g["err"], e)
        if "k_ms" not in g:  # the group's first flavour is timed
            g.update(k_ms=k_ms, p_ms=p_ms, name=name,
                     flops=run_bound(plan, k, semantics == "physics"),
                     nbytes=run_nbytes(plan, dev, src, st, jv0, lanes))
        phase("38 past the caps vs plain", t0,
              f"{name} ({semantics}/{'trap' if trap else 'be'}, np1="
              f"{plan.np1}, {sum(len(v) for v in plan.stype.values())} "
              f"sources, {sum(plan.counts[5:])} D/Q/M, a table of "
              f"{plan.topo.size} words): bucket {place[0]}, table in "
              f"{'shared' if place[1] else 'device'} memory, slice in "
              f"{'shared' if place[2] else 'device'} memory; {lanes} lanes,"
              f" {shape[1]} lanes a block, {shape[4]} B of shared memory a "
              f"block; launches {got}; over at most {attempts} attempts: "
              f"accepted {int(k.accepted.sum())}, attempts "
              f"{int(k.attempts.sum())}, NR iterations "
              f"{int(k.nr_iters.sum())}; counters equal, bit for bit, max "
              f"abs err {e:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        del k, p, out
        free()

    # ---- the store and its stream in 3 chunks, past each former cap
    for key, label, deck in (("store", "bus48", bus(48, "0.15n")),
                             ("store_table", "nmos_ring101",
                              nmos_ring(101, "1n"))):
        t0 = time.perf_counter()
        res[key] = st_ = store_stream_vs_plain(f"38 {label}", deck, lanes,
                                               {})
        if st_["chunks"] != 3:
            fail(f"38 {label} stream: {st_['chunks']} chunks, not 3")
        phase("38 past the caps vs plain", t0,
              f"store ({label}, store='full'): {lanes} lanes, store "
              f"launches 1, stored rows {st_['rows']}, bit for bit with "
              f"store_plain, kernel {st_['k_ms']:.3f} ms alone "
              f"({st_['w_ms']:.3f} ms with the wrapper), plain "
              f"{st_['p_ms']:.1f} ms; streamed in chunks of {st_['chunk']} "
              f"rows: {st_['chunks']} store launches, every chunk's rows "
              f"and the totals equal to the single launch's, the re-entry "
              f"bit for bit with the plain store; max abs err "
              f"{st_['err']:.3e}")
        free()

    # ---- the OP and DC sweep flavours at `lanes` lanes
    for name, deck, kind, place in PAST_CAPS_OPDC:
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(deck, src_spread, lanes)
        plan = run.make_plan(cc, "op")
        lane = (op if kind == "op" else dc).lane_doubles(plan)
        placed(name, run.placement(plan, lane), place)
        shape = op.segment_shape(plan, lanes, lane)
        pts = np.linspace(0.0, 5.0, 3)
        reset_counts()
        if kind == "op":
            ts.run_op_batch(cc, params, axes)
        else:
            ts.run_dc_batch(cc, (0,), params, axes, pts)
        torch.cuda.synchronize()
        got = counts()
        counter = "op_kernel" if kind == "op" else "dc_sweep_kernel"
        check_counts(f"38 {name} path", got,
                     {counter: (1, 64 if kind == "op" else 1)})
        if kind == "op":
            r, e, k_ms, p_ms, plan_k, n_ = op_vs_plain(f"38 {name}", cc,
                                                       params, state0)
            flops, nb = op_bound(plan_k, r, lanes, n_)
            what = (f"converged {int(r.converged.sum())} of {lanes}, "
                    f"{n_} launches")
        else:
            r, e, k_ms, p_ms, args = dc_vs_plain(f"38 {name}", cc, params,
                                                 state0, pts)
            flops, nb = dc_bound(args[0], r, *args[1:4], lanes, len(pts))
            what = (f"{len(pts)} points, converged {int(r.conv.sum())} of "
                    f"{lanes * len(pts)}")
        g = res.setdefault(kind + "_table", dict(launches=0, err=0.0))
        g["launches"] += got[counter]
        g["err"] = max(g["err"], e)
        if "k_ms" not in g:
            g.update(k_ms=k_ms, p_ms=p_ms, name=name, flops=flops,
                     nbytes=nb)
        phase("38 past the caps vs plain", t0,
              f"{name} (np1={plan.np1}, {sum(plan.counts[5:])} D/Q/M, a "
              f"table of {plan.topo.size} words): bucket {place[0]}, table "
              f"in {'shared' if place[1] else 'device'} memory, slice in "
              f"{'shared' if place[2] else 'device'} memory, {shape[1]} "
              f"lanes a block, {shape[4]} B of shared memory a block; "
              f"{lanes} lanes, {what}; bit for bit with the plain version, "
              f"max abs err {e:.3e}; kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms")
        del r
        free()
    return res


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card, "
              "no run", file=sys.stderr)
        return 2
    # the engine overrides would swap kernels for their plain versions or
    # the general engine; phase 33 sets TOYSPICE_SOLVER for its reference
    # pass alone
    forced = sorted(v for v in OVERRIDES if v in os.environ)
    if forced:
        print(f"chip_smoke: {', '.join(forced)} set: the kernels' paths "
              "would not run as measured; unset them", file=sys.stderr)
        return 2

    # ---------------------------------------------------------- 1 device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    phase("1 device", t0, f"{kind}, {count} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ----------------------------------------------- 2 build (started)
    # the libraries build in a thread of their own while phase 3's and
    # phase 27's plain versions run on the card: those need no library
    fresh = [name for name in _build.SOURCES
             if not _build.library_path(name).exists()]

    def build():
        b0 = time.perf_counter()
        libs = _build.build(extra_flags=("-Xptxas", "-v"))
        return (libs, dict(_build.build.log), dict(_build.build.seconds),
                time.perf_counter() - b0)

    builder = concurrent.futures.ThreadPoolExecutor(1)
    building = builder.submit(build)

    # -------------------------------- 3 run kernel vs plain, linear decks
    def small(keys, pwl=False):
        def overrides(cc, b):
            rng = np.random.default_rng(1)
            ov = perturbed(cc, rng, b, keys)
            if pwl:
                pv = np.asarray(cc.params["I"]["pwl_v"])
                ov["I"] = {"pwl_v": pv[None] * np.exp(
                    rng.normal(0.0, 0.1, size=(b,) + pv.shape))}
            return ov
        return overrides

    def bench_overrides(cc, b):
        # bench.py: numpy default_rng(0), R then L then C, spread 0.1
        return perturbed(cc, np.random.default_rng(0), b, ("R", "L", "C"))

    def nan_minstep(sc):
        return sc._replace(minstep=float("nan"))

    decks = [("rc_sin", RC_SIN, small(("R", "C")), SMALL_LANES, None),
             ("rl_pulse", RL_PULSE, small(("R", "L")), SMALL_LANES, None),
             ("ipwl_ladder", IPWL, small(("R", "C"), pwl=True), SMALL_LANES,
              None),
             ("rl_nan_minstep", RL_PULSE, small(("R", "L")), NAN_LANES,
              nan_minstep),
             ("ladder32_rows_in_memory", LADDER32, small(("R", "C")),
              SMALL_LANES, None),
             ("bench_rlc", RLC, bench_overrides, BENCH_LANES, None)]
    lin_err = 0.0
    bench = None

    plains = []
    for name, deck, ov, b, edit in decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(deck, ov, b)
        plan, dev, src, st, sc, _ = lane_inputs(cc, cfg, params, state0)
        if edit:
            sc = edit(sc)
        plains.append((plan, dev, src, st, sc,
                       *plain_timed(plan, dev, src, st, sc),
                       time.perf_counter() - t0))

    gj_sets = gj_plain_sets(GJ_LANES)  # phase 27's, beside the build too

    # ------------------------------------------------ 2 build (finished)
    libs, logs, lib_s, build_s = building.result()
    builder.shutdown()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[2 build] built {fresh or 'nothing'} with one nvcc call per "
          "library, started together, beside phase 3's plain versions: "
          + ", ".join(p.name for p in libs.values()) + "; each call's end, "
          "s from the start: " + ", ".join(
              f"{name} {sec:.1f}" for name, sec in sorted(
                  lib_s.items(), key=lambda kv: kv[1]))
          + f" ({build_s:.3f} s)", flush=True)
    for name, text in logs.items():
        print(f"[2 ptxas] {name}: {'; '.join(ptxas_summary(text))}",
              flush=True)

    for (name, deck, ov, b, edit), (plan, dev, src, st, sc, p, p_ms,
                                    p_s) in zip(decks, plains):
        t0 = time.perf_counter() - p_s  # the plain version's seconds too
        k, k_ms = run_timed(plan, dev, src, st, sc)
        err = compare_run(name, k, p)
        lin_err = max(lin_err, err)
        attempts = int(k.attempts.sum())
        phase("3 kernel vs plain", t0,
              f"{name}: {b} lanes, np1={plan.np1}, accepted "
              f"{int(k.accepted.sum())}, attempts {attempts}, failed "
              f"{int(k.fail.sum())}; counters equal, bit for bit, max abs err "
              f"{err:.3e}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if edit is nan_minstep and not (
                bool(torch.isnan(k.t).all()) and bool(k.fail.all())
                and k.attempts.tolist() == [2] * b):
            fail(f"{name}: expected every lane to fail after 2 attempts "
                 "with t NaN, as the general engine does")
        if name == "bench_rlc":
            bench = dict(k=k, k_ms=k_ms, p_ms=p_ms, plan=plan, dev=dev,
                         src=src, st=st, attempts=attempts)

    # ----------------------------------------------- 4 linear main path
    t0 = time.perf_counter()
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, bench_overrides(cc, BENCH_LANES))
    state0 = ts.init_state(cc)
    fn = ts.make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    lin_launches = got["run_kernel"]
    accepted = int(out.accepted.sum())
    attempts = int(out.attempts.sum())
    failed = int(out.fail.sum())
    if fn.engine != "run":
        fail(f"main path engine {fn.engine!r}, expected 'run'")
    check_counts("linear main path", got, {"run_kernel": (1, 1)})
    if failed:
        fail(f"{failed} of {BENCH_LANES} lanes failed")
    if out.accepted.shape != (BENCH_LANES,) or out.t_final.shape != (
            BENCH_LANES,):
        fail("main path outputs have the wrong shape")
    if not bool((out.t_final == cfg.tstop).all()):
        fail("a lane stopped before tstop")
    for kind_ in out.state.values():
        for leaf in kind_.values():
            if leaf.shape[0] != BENCH_LANES or not bool(
                    torch.isfinite(leaf).all()):
                fail("main path state is not finite or has the wrong shape")
    k = bench["k"]
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.t_final, k.t)):
        fail("main path differs from phase 3's kernel run on the same lanes")
    rate = accepted / wall
    bench_none, bench_wall = out, wall
    seg_w, seg_lanes, seg_blocks, seg_threads, seg_shmem = \
        run.segment_shape(bench["plan"], BENCH_LANES)[:5]
    phase("4 main path", t0,
          f"engine={fn.engine}, launches={lin_launches}, "
          f"lanes={BENCH_LANES}, accepted={accepted}, attempts={attempts}, "
          f"failed={failed}, wall={wall:.6f} s, {rate:.6e} accepted steps/s "
          f"on {smi}; launch shape (the library's): segments of "
          f"W={seg_w} threads, {seg_lanes} lanes a block, {seg_blocks} "
          f"blocks of {seg_threads} threads, {seg_shmem} B of shared "
          "memory a block")

    # ------------------------------------- 5 OP kernel vs plain version
    def r_spread(cc, b):
        return perturbed(cc, np.random.default_rng(0), b, ("R",))

    def v1_draw(cc, b):
        return {"V": {"dc": np.random.default_rng(0).uniform(2.0, 100.0,
                                                              (b, 1))}}

    op_decks = [
        ("half_wave_rectifier", deck_file("half_wave_rectifier.cir"),
         rc_spread, BENCH_LANES),
        ("ce_amplifier_op", deck_file("ce_amplifier_op.cir"), r_spread,
         BENCH_LANES),
        ("diode_divider", D_DIV, r_spread, BENCH_LANES),
        ("mosfet_bias", M_BIAS, r_spread, BENCH_LANES),
        ("hard_v", HARD_V, v1_draw, RESCUE_LANES),
        ("hard_i", HARD_I, lambda cc, b: {"I": {"dc": np.ones((b, 1))}},
         RESCUE_LANES)]
    op_err = 0.0
    op_main = None
    for name, deck, ov, b in op_decks:
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(deck, ov, b)
        fk = op.make_op_fused(cc, DEFAULTS, solve=op.op_lanes)
        fk(params, state0)  # warm-up
        tk = TimedSolve(op.op_lanes)
        tp_ = TimedSolve(op.op_plain)
        op.launch_op_kernel.launches = 0
        k = op.make_op_fused(cc, DEFAULTS, solve=tk)(params, state0)
        launches = op.launch_op_kernel.launches
        p = op.make_op_fused(cc, DEFAULTS, solve=tp_)(params, state0)
        k_ms, p_ms = tk.ms(), tp_.ms()
        for key in ("converged", "stage", "iters", "iters_all"):
            if not torch.equal(getattr(k, key), getattr(p, key)):
                fail(f"{name}: OP {key} differs from the plain version")
        pairs = [("x", k.x, p.x)] + [
            (f"jv.{kd}.{key}", k.jv[kd][key], p.jv[kd][key])
            for kd in k.jv for key in k.jv[kd]]
        err = exact_err(name, pairs)
        op_err = max(op_err, err)
        stages = torch.bincount(k.stage.long(), minlength=3).tolist()
        conv = int(k.converged.sum())
        if name == "hard_v" and not (stages[0] and stages[2]
                                     and conv == b):
            fail("hard_v: expected lanes at stages 0 and 2, all converged")
        if name == "hard_i" and (conv or stages[2] != b):
            fail("hard_i: expected every lane through the whole ladder and "
                 "none converged (source stepping scales V sources only)")
        if name not in ("hard_v", "hard_i") and conv != b:
            fail(f"{name}: {b - conv} lanes did not converge")
        phase("5 OP kernel vs plain", t0,
              f"{name}: {b} lanes, np1={cc.np1}, stages {stages}, "
              f"converged {conv}, NR iterations stage 0 "
              f"{int(k.iters.sum())}, all {int(k.iters_all.sum())}, "
              f"launches {launches}; equal counts, bit for bit, max abs err "
              f"{err:.3e}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name == "half_wave_rectifier":
            # bytes of each launch: dev and dyn rows, x and jv in and out,
            # the two counters, the plan
            plan_op = fk.plan
            per_lane = 8 * (plan_op.nd + op.dyn_width(plan_op)
                            + 2 * (plan_op.np1 + plan_op.kj)) + 8
            op_main = dict(k_ms=k_ms, p_ms=p_ms, plan=plan_op,
                           iters=int(k.iters_all.sum()),
                           nbytes=launches * (b * per_lane
                                              + plan_op.topo.nbytes))

    # ------------------------- 6 run kernel vs plain, nonlinear decks
    nl_decks = [("half_wave_rectifier", deck_file("half_wave_rectifier.cir")),
                ("nmos_inverter_tran", deck_file("nmos_inverter_tran.cir")),
                ("bjt_ce_tran", BJT_TRAN)]
    nl_err = 0.0
    hwr = None
    for name, deck in nl_decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(deck, rc_spread, BENCH_LANES)
        plan, dev, src, st, sc, jv0 = lane_inputs(cc, cfg, params, state0)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
        err = compare_run(name, k, p, check_jv=True)
        nl_err = max(nl_err, err)
        acc_ = int(k.accepted.sum())
        att_ = int(k.attempts.sum())
        nri = int(k.nr_iters.sum())
        phase("6 nonlinear kernel vs plain", t0,
              f"{name}: {BENCH_LANES} lanes, np1={plan.np1}, accepted "
              f"{acc_}, attempts {att_}, NR iterations {nri}, failed "
              f"{int(k.fail.sum())}; counters equal, bit for bit, max abs "
              f"err {err:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name == "half_wave_rectifier":
            hwr = dict(k=k, k_ms=k_ms, p_ms=p_ms, plan=plan, attempts=att_,
                       nri=nri, nbytes=nbytes(dev, src, st, jv0)
                       + nbytes(st, jv0) + plan.topo.nbytes
                       + BENCH_LANES * (8 + 8 + 4 + 4 + 4 + 4))

    # --------------------------------------- 7 nonlinear main path
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("half_wave_rectifier.cir"), rc_spread, BENCH_LANES)
    fn = ts.make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    nl_launches = got["run_kernel"]
    op_launches = got["op_kernel"]
    accepted = int(out.accepted.sum())
    attempts = int(out.attempts.sum())
    nri = int(out.nr_iters.sum())
    failed = int(out.fail.sum())
    if fn.engine != "run":
        fail(f"nonlinear main path engine {fn.engine!r}, expected 'run'")
    check_counts("nonlinear main path", got,
                 {"run_kernel": (1, 1), "op_kernel": (1, 1 << 30)})
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"{failed} of {BENCH_LANES} lanes failed or stopped early")
    k = hwr["k"]
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.nr_iters, k.nr_iters)
            and torch.equal(out.t_final, k.t)
            and torch.equal(out.jv["D"]["vd"], k.jv)):
        fail("nonlinear main path differs from phase 6's kernel run")
    hwr_none = out
    phase("7 nonlinear main path", t0,
          f"half_wave_rectifier: engine={fn.engine}, run kernel launches="
          f"{nl_launches}, OP kernel launches={op_launches}, "
          f"lanes={BENCH_LANES}, accepted={accepted}, attempts={attempts}, "
          f"failed={failed}, NR iterations per attempt "
          f"{nri / attempts:.6f}, wall={wall:.6f} s, "
          f"{accepted / wall:.6e} accepted steps/s on {smi}")

    stamped = stamped_phases(BENCH_LANES)
    dc_main = dc_phase(BENCH_LANES)
    ac_main = ac_phase(BENCH_LANES)
    mag_err = magnetic_phases(SMALL_LANES, BENCH_LANES, smi)
    store = store_phases(SMALL_LANES, BENCH_LANES, smi, hwr_none)
    stream = stream_phase(BENCH_LANES, SMALL_LANES, smi, bench, bench_none,
                          bench_overrides)
    resume_phase(SMALL_LANES, bench_overrides)
    phys_run_err, phys_store_err = physics_run_phase(SMALL_LANES)
    phys_op = physics_op_phase(BENCH_LANES)
    phys_dc = physics_dc_phase(BENCH_LANES)
    phys = physics_main_phase(BENCH_LANES, smi)
    mag_run_err, mag_store = mag_run_phase(SMALL_LANES, smi)
    mag_nl = mag_newton_phase(SMALL_LANES, smi)
    mag_ac_err = mag_ac_phase(BENCH_LANES)
    mag = mag_main_phase(BENCH_LANES, smi)
    phys_store = physics_store_phase(BENCH_LANES, smi)
    gj_err = gj_phase(GJ_LANES, gj_sets)
    del gj_sets
    gen_err = general_vs_run_phase(SMALL_LANES)
    stamped_big, gj_seed, run_wide, op_wide, cw16 = cw16_phase(BENCH_LANES,
                                                               smi)
    gj_ac, ac_rows = lc16_phase(BENCH_LANES, smi)
    compat_trap_phase(1024)
    st_work, gj_work, ac_wide = past_nbig_phase(1024, smi)
    st_single, gj_single = user_surface_phase(smi)
    mesh_phase(smi, bench_none, bench_wall, bench_overrides, 1024)
    wide = wide_phase(GJ_LANES, BENCH_LANES, smi)
    block = block_phase(GJ_LANES, BENCH_LANES, smi, st_work)
    ac_buckets = ac_bucket_phase(GJ_LANES, smi)
    past = past_caps_phase(GJ_LANES, BENCH_LANES, smi)

    # ------------------------------------------------ 11 the kernels line
    plan = bench["plan"]
    lin_bytes = nbytes(bench["dev"], bench["src"], bench["st"]) \
        + plan.topo.nbytes + nbytes(bench["st"]) \
        + BENCH_LANES * (8 + 8 + 4 + 4 + 4 + 4)
    lin_bound = bound(attempt_flops(plan) * bench["attempts"], lin_bytes)
    print(f"[17 bound] run_kernel linear (bench_rlc): {attempt_flops(plan)} "
          f"f64 operations per attempt x {bench['attempts']} attempts / "
          f"{PEAK_F64:.3g} op/s = {lin_bound[2]:.6f} ms; {lin_bytes} bytes / "
          f"{PEAK_BYTES:.3g} B/s = {lin_bound[3]:.6f} ms", flush=True)
    sb = bound(stream["flops"], stream["nbytes"])
    print(f"[17 bound] run_kernel store (bench_rlc_8192_streamed, "
          f"{stream['chunks']} launches, {stream['rows']} kept rows): "
          f"{stream['flops']} f64 operations / {PEAK_F64:.3g} op/s = "
          f"{sb[2]:.6f} ms; {stream['nbytes']} bytes (the kept rows, the "
          f"inputs, the state and counters) / {PEAK_BYTES:.3g} B/s = "
          f"{sb[3]:.6f} ms", flush=True)
    hp = hwr["plan"]
    nl_flops = hwr["attempts"] * step_flops(hp) + hwr["nri"] * newton_flops(
        hp)
    nl_bound = bound(nl_flops, hwr["nbytes"])
    print(f"[17 bound] run_kernel nonlinear (half_wave_rectifier): "
          f"{hwr['attempts']} attempts x {step_flops(hp)} + {hwr['nri']} "
          f"Newton iterations x {newton_flops(hp)} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {nl_bound[2]:.6f} ms; {hwr['nbytes']} "
          f"bytes / {PEAK_BYTES:.3g} B/s = {nl_bound[3]:.6f} ms", flush=True)
    opp = op_main["plan"]
    seed = BENCH_LANES * (build_flops(opp, opp.entries[:opp.n_lin])
                          + lu_flops(opp.np1))
    op_flops = op_main["iters"] * newton_flops(opp) + seed
    op_bound = bound(op_flops, op_main["nbytes"])
    print(f"[17 bound] op_kernel (half_wave_rectifier bias): "
          f"{op_main['iters']} Newton iterations x {newton_flops(opp)} + "
          f"{BENCH_LANES} linear estimates, {op_flops} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {op_bound[2]:.6f} ms; "
          f"{op_main['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{op_bound[3]:.6f} ms", flush=True)

    st_bound = bound(stamped["flops"], stamped["nbytes"])
    print(f"[17 bound] stamped_solve (divider_op + divider sweep): "
          f"{stamped['systems']} systems, {stamped['flops']} f64 operations "
          f"/ {PEAK_F64:.3g} op/s = {st_bound[2]:.6f} ms; "
          f"{stamped['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{st_bound[3]:.6f} ms", flush=True)
    dp = dc_main["plan"]
    dc_per_iter = newton_flops(dp) - (dp.np1 - 1)  # no gmin diagonal
    dc_bound = bound(dc_main["iters"] * dc_per_iter, dc_main["nbytes"])
    print(f"[17 bound] dc_sweep_kernel (diode_iv_sweep): "
          f"{dc_main['iters']} Newton iterations x {dc_per_iter} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {dc_bound[2]:.6f} ms; "
          f"{dc_main['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{dc_bound[3]:.6f} ms", flush=True)
    sp = store["plan"]
    store_flops = store["attempts"] * step_flops(sp) + store[
        "nri"] * newton_flops(sp)
    store_bound = bound(store_flops, store["nbytes"])
    print(f"[17 bound] run_kernel store (half_wave_rectifier, "
          f"store='full'): {store['attempts']} attempts x {step_flops(sp)} "
          f"+ {store['nri']} Newton iterations x {newton_flops(sp)} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {store_bound[2]:.6f} ms; "
          f"{store['nbytes']} bytes (the inputs, the state and counters, "
          f"and the whole zeroed output) / {PEAK_BYTES:.3g} B/s = "
          f"{store_bound[3]:.6f} ms", flush=True)
    pp = phys["plan"]
    phys_flops = phys["attempts"] * phys_step_flops(pp) + phys[
        "nri"] * phys_newton_flops(pp)
    phys_bound = bound(phys_flops, phys["nbytes"])
    print(f"[17 bound] run_kernel physics (half_wave_rectifier, trap): "
          f"{phys['attempts']} attempts x {phys_step_flops(pp)} + "
          f"{phys['nri']} Newton iterations x {phys_newton_flops(pp)} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {phys_bound[2]:.6f} ms; "
          f"{phys['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{phys_bound[3]:.6f} ms", flush=True)
    pop = phys_op["plan"]
    pop_flops = phys_op["iters"] * phys_newton_flops(pop) + BENCH_LANES * (
        build_flops(pop, pop.entries[:pop.n_lin]) + lu_flops(pop.np1))
    pop_bound = bound(pop_flops, phys_op["nbytes"])
    print(f"[17 bound] op_kernel physics (half_wave_rectifier bias): "
          f"{phys_op['iters']} Newton iterations x {phys_newton_flops(pop)} "
          f"+ {BENCH_LANES} linear estimates, {pop_flops} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {pop_bound[2]:.6f} ms; "
          f"{phys_op['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{pop_bound[3]:.6f} ms", flush=True)
    pdp = phys_dc["plan"]
    pdc_per_iter = phys_newton_flops(pdp, rs_share=1.0) - (pdp.np1 - 1)
    pdc_bound = bound(phys_dc["iters"] * pdc_per_iter, phys_dc["nbytes"])
    print(f"[17 bound] dc_sweep_kernel physics (diode_iv_sweep, Rs on "
          f"every lane): {phys_dc['iters']} Newton iterations x "
          f"{pdc_per_iter} f64 operations / {PEAK_F64:.3g} op/s = "
          f"{pdc_bound[2]:.6f} ms; {phys_dc['nbytes']} bytes / "
          f"{PEAK_BYTES:.3g} B/s = {pdc_bound[3]:.6f} ms", flush=True)
    ac_bound = bound(ac_main["flops"], ac_main["nbytes"])
    print(f"[17 bound] ac_kernel (ce_amplifier_ac): {ac_main['flops']} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {ac_bound[2]:.6f} ms; "
          f"{ac_main['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{ac_bound[3]:.6f} ms", flush=True)

    ac_bounds = {}
    for key, what, label in (
            ("rows", ac_rows, "lc16_ac_8192's main path"),
            ("wide", ac_wide, "lc31_ac_8192's main path")) + tuple(
            (name, r, f"phase 37's {name}, np1 = {r['np1']}")
            for name, r in ac_buckets.items()):
        ac_bounds[key] = bd = bound(what["flops"], what["nbytes"])
        print(f"[17 bound] ac_kernel {ac_body(what['n2'])} ({label}, "
              f"{what['systems']} systems of {what['n2']}, kernel "
              f"{what['k_ms']:.3f} ms): {what['flops']} f64 operations / "
              f"{PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; {what['nbytes']} bytes "
              f"/ {PEAK_BYTES:.3g} B/s = {bd[3]:.6f} ms", flush=True)

    mag_bound = bound(mag["flops"], mag["nbytes"])
    mp_ = mag["plan"]
    print(f"[17 bound] run_kernel physics magnetic (saturating_transformer, "
          f"trap): {mag['attempts']} attempts x "
          f"{phys_mag_attempt_flops(mp_)} + {mag['accepted']} J-A commits x "
          f"{ja_commit_flops(mp_)} = {mag['flops']} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {mag_bound[2]:.6f} ms; {mag['nbytes']} "
          f"bytes / {PEAK_BYTES:.3g} B/s = {mag_bound[3]:.6f} ms",
          flush=True)
    mag_bounds = {}
    for key, what, label in (
            ("phys_store", phys_store, "run_kernel physics store "
             "(half_wave_rectifier, trap, store='full', the inputs, state, "
             "counters and the whole zeroed output)"),
            ("store", mag_store, "run_kernel physics magnetic store "
             "(saturating_transformer, trap, 256 lanes)"),
            ("run_compat", mag_nl["run_compat"], "run_kernel magnetic "
             "Newton (lm_diode, compat, 256 lanes)"),
            ("run_physics", mag_nl["run_physics"], "run_kernel physics "
             "magnetic Newton (lm_diode, trap, 256 lanes)"),
            ("op_compat", mag_nl["op_compat"], "op_kernel magnetic "
             "(lm_diode, 256 lanes)"),
            ("op_physics", mag_nl["op_physics"], "op_kernel magnetic "
             "physics (lm_diode, 256 lanes)"),
            ("dc_compat", mag_nl["dc_compat"], "dc_sweep_kernel magnetic "
             "(lm_diode, 256 lanes x 15 points)"),
            ("dc_physics", mag_nl["dc_physics"], "dc_sweep_kernel magnetic "
             "physics (lm_diode, 256 lanes x 15 points)")):
        mag_bounds[key] = bd = bound(what["flops"], what["nbytes"])
        print(f"[17 bound] {label}: {what['flops']} f64 operations / "
              f"{PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; {what['nbytes']} "
              f"bytes / {PEAK_BYTES:.3g} B/s = {bd[3]:.6f} ms", flush=True)

    sb_bound = bound(stamped_big["flops"], stamped_big["nbytes"])
    print(f"[17 bound] stamped_solve warp (cw16_8192's first 0.1 ms, "
          f"{stamped_big['calls']} launches, n={stamped_big['n']}, "
          f"{stamped_big['terms']} terms): "
          f"{stamped_big['flops']} f64 operations / {PEAK_F64:.3g} op/s = "
          f"{sb_bound[2]:.6f} ms; {stamped_big['nbytes']} bytes / "
          f"{PEAK_BYTES:.3g} B/s = {sb_bound[3]:.6f} ms", flush=True)
    swb = bound(st_work["flops"], st_work["nbytes"])
    print(f"[17 bound] stamped_solve {solve.body(st_work['n'])} (the "
          f"127-stage rc ladder, {st_work['calls']} launches, "
          f"n={st_work['n']}, "
          f"{st_work['terms']} terms): {st_work['flops']} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {swb[2]:.6f} ms; {st_work['nbytes']} bytes "
          f"/ {PEAK_BYTES:.3g} B/s = {swb[3]:.6f} ms", flush=True)
    gwb = bound(gj_work["flops"], gj_work["nbytes"])
    print(f"[17 bound] gj_kernel {solve.body(gj_work['n'])} (lc31's AC, "
          f"{gj_work['systems']} systems of {gj_work['n']}): "
          f"{gj_work['flops']} f64 operations / {PEAK_F64:.3g} op/s = "
          f"{gwb[2]:.6f} ms; {gj_work['nbytes']} bytes / {PEAK_BYTES:.3g} "
          f"B/s = {gwb[3]:.6f} ms", flush=True)
    single_bounds = {}
    for key, what, label in (
            ("stamped", st_single, "stamped_solve at B = 1 (the user "
             "surface's six decks"),
            ("gj", gj_single, "gj_kernel at B = 1 (the user surface's OP "
             "seeds and AC systems")):
        single_bounds[key] = bd = bound(what["flops"], what["nbytes"])
        print(f"[17 bound] {label}, {what['calls']} launches): "
              f"{what['flops']} f64 operations / {PEAK_F64:.3g} op/s = "
              f"{bd[2]:.6f} ms; {what['nbytes']} bytes / {PEAK_BYTES:.3g} "
              f"B/s = {bd[3]:.6f} ms", flush=True)
    gj_flops = gj_seed["flops"] + gj_ac["flops"]
    gj_bytes = gj_seed["nbytes"] + gj_ac["nbytes"]
    gj_bound = bound(gj_flops, gj_bytes)
    print(f"[17 bound] gj_kernel (cw16_8192's seed, {gj_seed['systems']} "
          f"systems of {gj_seed['n']}, and lc16_ac_8192 under "
          f"TOYSPICE_AC=general, "
          f"{gj_ac['systems']} systems of {gj_ac['n']}): {gj_flops} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {gj_bound[2]:.6f} ms; "
          f"{gj_bytes} bytes / {PEAK_BYTES:.3g} B/s = {gj_bound[3]:.6f} ms; "
          f"lc16 alone: {bound(gj_ac['flops'], gj_ac['nbytes'])[0]:.6f} ms",
          flush=True)

    cb = bound(cw16["flops"], cw16["nbytes"])
    print(f"[17 bound] run_kernel 64-row bucket (cw16_8192's main path, "
          f"its run launch alone {cw16['main_ms']:.3f} ms): "
          f"{cw16['flops']} f64 operations / {PEAK_F64:.3g} op/s = "
          f"{cb[2]:.6f} ms; {cw16['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{cb[3]:.6f} ms", flush=True)
    wide_bounds = {}
    for key, what, label in (
            ("run", run_wide, "run_kernel 64-row bucket (cw16_8192's "
             "first 0.1 ms, 8192 lanes)"),
            ("op", op_wide, "op_kernel 64-row bucket (cw16_8192's OP)"),
            ("linear", wide["linear"], "run_kernel 64-row bucket linear "
             "(rc ladder, np1 = 64, 259 lanes)"),
            ("physics", wide["physics"], "run_kernel physics 64-row "
             "bucket (cw16 to 0.1 ms, trap, 259 lanes)"),
            ("magnetic", wide["magnetic"], "run_kernel magnetic 64-row "
             "bucket (the magnetic ladder, np1 = 35, 259 lanes)"),
            ("physics_magnetic", wide["physics_magnetic"], "run_kernel "
             "physics magnetic 64-row bucket (the magnetic ladder, trap)"),
            ("magnetic_newton", wide["magnetic_newton"], "run_kernel "
             "magnetic Newton 64-row bucket (the ladder with a diode)"),
            ("physics_magnetic_newton", wide["physics_magnetic_newton"],
             "run_kernel physics magnetic Newton 64-row bucket (the ladder "
             "with a diode, trap)"),
            ("store", wide["store"], "run_kernel store 64-row bucket (cw16 "
             "to 0.1 ms, 259 lanes, the inputs, state and counters and the "
             "whole zeroed output)"),
            ("dc", wide["dc_compat"], "dc_sweep_kernel 64-row bucket (32 "
             "diodes, 8192 lanes x 9 points)")):
        wide_bounds[key] = bd = bound(what["flops"], what["nbytes"])
        print(f"[17 bound] {label}: {what['flops']} f64 operations / "
              f"{PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; {what['nbytes']} "
              f"bytes / {PEAK_BYTES:.3g} B/s = {bd[3]:.6f} ms", flush=True)

    block_bounds = {}
    for key, label in (
            ("rc127", "rc127_8192's first 259 lanes, to 0.05 ms"),
            ("newton", "cw32_8192's first 259 lanes, the first 0.1 ms"),
            ("op", "cw32_8192's OP"),
            ("dc_compat", "64 diodes, 259 of 8192 lanes x 9 points"),
            ("linear", "rc ladder, np1 = 65, 259 lanes"),
            ("physics", "cw32 to 0.1 ms, trap, 259 lanes"),
            ("magnetic", "the magnetic ladder, np1 = 67, 259 lanes"),
            ("physics_magnetic", "the magnetic ladder, trap"),
            ("magnetic_newton", "the ladder with a diode"),
            ("physics_magnetic_newton", "the ladder with a diode, trap"),
            ("device_memory", "rc ladder, np1 = 183, 259 lanes, the "
             "device-memory workspace"),
            ("store", "rc127 to 0.05 ms, 259 lanes, the inputs, state and "
             "counters and the whole zeroed output")):
        what = block[key]
        block_bounds[key] = bd = bound(what["flops"], what["nbytes"])
        print(f"[17 bound] block bucket {key} ({label}): {what['flops']} "
              f"f64 operations / {PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; "
              f"{what['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
              f"{bd[3]:.6f} ms", flush=True)
    for key, label in (("rc127", "rc127_8192's run launch"),
                       ("newton", "cw32_8192's run launch")):
        what = block[key]
        bd = bound(what["main_flops"], what["main_bytes"])
        print(f"[17 bound] block bucket main path ({label} alone "
              f"{what['main_ms']:.3f} ms): {what['main_flops']} f64 "
              f"operations / {PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; "
              f"{what['main_bytes']} bytes / {PEAK_BYTES:.3g} B/s = "
              f"{bd[3]:.6f} ms", flush=True)

    past_bounds = {}
    for key, label in (("nmos", "nmos_ring101 vs plain, 259 lanes, the "
                        f"first {NMOS_SPAN:g} s"),
                       ("bus", "bus48 vs plain, 259 lanes, the first "
                        f"{BUS_SPAN:g} s"),
                       ("pv_op", "pv72's OP, 259 lanes"),
                       ("pv_dc", "pv72's sweep, 259 lanes, its first points"),
                       ("sources", None), ("physics", None),
                       ("magnetic", None), ("physics_magnetic", None),
                       ("table", None), ("store", "bus48 store, 259 lanes"),
                       ("store_table", "nmos_ring101 store, 259 lanes"),
                       ("op_table", None), ("dc_table", None)):
        what = past[key]
        past_bounds[key] = bd = bound(what["flops"], what["nbytes"])
        print(f"[17 bound] past the caps {key} "
              f"({label or what['name'] + ', 259 lanes'}): {what['flops']} "
              f"f64 operations / {PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; "
              f"{what['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
              f"{bd[3]:.6f} ms", flush=True)
    for key, label in (("nmos", "nmos_ring101_8192's path"),
                       ("bus", "bus48_8192's path")):
        what = past[key]
        bd = bound(what["main_flops"], what["main_bytes"])
        print(f"[17 bound] past the caps main path ({label}, its run "
              f"launch and host work {what['main_ms']:.3f} ms): "
              f"{what['main_flops']} f64 "
              f"operations / {PEAK_F64:.3g} op/s = {bd[2]:.6f} ms; "
              f"{what['main_bytes']} bytes / {PEAK_BYTES:.3g} B/s = "
              f"{bd[3]:.6f} ms", flush=True)

    def entry(name, source, replaces, launches, err, k_ms, p_ms, bd,
              lib_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib_ms}

    run_src = "toyspice_tpu_torch/csrc/run_kernel.cu"
    mag_src = "toyspice_tpu_torch/csrc/run_kernel_mag.cu"
    line = {"kernels": [
        entry("run_kernel", run_src, "toyspice_tpu/ops/pallas_run.py:652",
              lin_launches, max(lin_err, mag_err), bench["k_ms"],
              bench["p_ms"], lin_bound),
        entry("run_kernel_nonlinear", run_src,
              "toyspice_tpu/ops/pallas_run.py:652", nl_launches, nl_err,
              hwr["k_ms"], hwr["p_ms"], nl_bound),
        entry("run_kernel_store", run_src,
              "toyspice_tpu/ops/pallas_tran.py:1429", store["launches"],
              max(store["err"], stream["err"], phys_store_err),
              store["k_ms"], store["p_ms"], store_bound),
        entry("run_kernel_physics",
              "toyspice_tpu_torch/csrc/run_kernel_phys.cu",
              "toyspice_tpu/ops/pallas_run.py:652", phys["launches"],
              max(phys["err"], phys_run_err), phys["k_ms"], phys["p_ms"],
              phys_bound),
        entry("op_kernel", "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230", op_launches, op_err,
              op_main["k_ms"], op_main["p_ms"], op_bound),
        entry("stamped_solve", "toyspice_tpu_torch/csrc/stamped_solve.cu",
              "toyspice_tpu/ops/pallas_solve.py:337", stamped["launches"],
              stamped["err"], stamped["k_ms"], stamped["p_ms"], st_bound,
              stamped["lib_ms"]),
        entry("op_kernel_physics", "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230", phys["op_launches"],
              phys_op["err"], phys_op["k_ms"], phys_op["p_ms"], pop_bound),
        entry("dc_sweep_kernel", "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431", dc_main["launches"],
              dc_main["err"], dc_main["k_ms"], dc_main["p_ms"], dc_bound),
        entry("dc_sweep_kernel_physics",
              "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431", phys_dc["launches"],
              phys_dc["err"], phys_dc["k_ms"], phys_dc["p_ms"], pdc_bound),
        entry("ac_kernel", "toyspice_tpu_torch/csrc/ac_kernel.cu",
              "toyspice_tpu/ops/pallas_ac.py:102", ac_main["launches"],
              max(ac_main["err"], mag_ac_err, ac_buckets["lc14"]["err"]),
              ac_main["k_ms"], ac_main["p_ms"], ac_bound, ac_main["lib_ms"]),
    ] + [entry(f"ac_kernel_{key}", "toyspice_tpu_torch/csrc/ac_kernel.cu",
               "toyspice_tpu/ops/pallas_ac.py:102", what["launches"],
               max([what["err"]] + [ac_buckets[n_]["err"] for n_ in more]),
               what["k_ms"], what["p_ms"], ac_bounds[bkey], what["lib_ms"])
         for key, what, bkey, more in (
             ("rows", ac_rows, "rows", ("lc15", "lc22", "rc30", "diodes29",
                                        "diodes29_physics")),
             ("wide", ac_wide, "wide", ("lc23", "lc34")),
             ("shared", ac_buckets["lc40"], "lc40", ("lc35",)),
             ("device_memory", ac_buckets["lc50"], "lc50", ("lc41",)))] + [
        entry("run_kernel_physics_magnetic", mag_src,
              "toyspice_tpu/ops/pallas_run.py:652", mag["launches"],
              max(mag["err"], mag_run_err), mag["k_ms"], mag["p_ms"],
              mag_bound),
        entry("run_kernel_physics_store",
              "toyspice_tpu_torch/csrc/run_kernel_phys.cu",
              "toyspice_tpu/ops/pallas_tran.py:1429", phys_store["launches"],
              phys_store["err"], phys_store["k_ms"], phys_store["p_ms"],
              mag_bounds["phys_store"]),
        entry("run_kernel_physics_magnetic_store", mag_src,
              "toyspice_tpu/ops/pallas_tran.py:1429", mag_store["launches"],
              mag_store["err"], mag_store["k_ms"], mag_store["p_ms"],
              mag_bounds["store"]),
    ] + [entry(name, src_, repl, mag_nl[key]["launches"],
               mag_nl[key]["err"], mag_nl[key]["k_ms"], mag_nl[key]["p_ms"],
               mag_bounds[key])
         for name, key, src_, repl in (
             ("run_kernel_magnetic_newton", "run_compat", mag_src,
              "toyspice_tpu/ops/pallas_run.py:652"),
             ("run_kernel_physics_magnetic_newton", "run_physics", mag_src,
              "toyspice_tpu/ops/pallas_run.py:652"),
             ("op_kernel_magnetic", "op_compat",
              "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230"),
             ("op_kernel_magnetic_physics", "op_physics",
              "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230"),
             ("dc_sweep_kernel_magnetic", "dc_compat",
              "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431"),
             ("dc_sweep_kernel_magnetic_physics", "dc_physics",
              "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431"))] + [
        entry("gj_kernel", "toyspice_tpu_torch/csrc/gj_kernel.cu",
              "toyspice_tpu/ops/pallas_solve.py:235",
              gj_seed["launches"] + gj_ac["launches"],
              max(gj_err, gj_ac["err"]), gj_seed["k_ms"] + gj_ac["k_ms"],
              gj_seed["p_ms"] + gj_ac["p_ms"], gj_bound,
              gj_seed["lib_ms"] + gj_ac["lib_ms"]),
        entry("stamped_solve_warp",
              "toyspice_tpu_torch/csrc/stamped_solve.cu",
              "toyspice_tpu/ops/pallas_solve.py:337",
              stamped_big["launches"], max(stamped_big["err"], gen_err),
              stamped_big["k_ms"], stamped_big["p_ms"], sb_bound,
              stamped_big["lib_ms"]),
        entry("stamped_solve_wide",
              "toyspice_tpu_torch/csrc/stamped_solve.cu",
              "toyspice_tpu/ops/pallas_solve.py:337", st_work["launches"],
              st_work["err"], st_work["k_ms"], st_work["p_ms"], swb,
              st_work["lib_ms"]),
        entry("gj_kernel_wide",
              "toyspice_tpu_torch/csrc/gj_kernel.cu",
              "toyspice_tpu/ops/pallas_solve.py:235", gj_work["launches"],
              gj_work["err"], gj_work["k_ms"], gj_work["p_ms"], gwb,
              gj_work["lib_ms"]),
        entry("stamped_solve_single",
              "toyspice_tpu_torch/csrc/stamped_solve.cu",
              "toyspice_tpu/ops/pallas_solve.py:337", st_single["launches"],
              st_single["err"], st_single["k_ms"], st_single["p_ms"],
              single_bounds["stamped"], st_single["lib_ms"]),
        entry("gj_kernel_single", "toyspice_tpu_torch/csrc/gj_kernel.cu",
              "toyspice_tpu/ops/pallas_solve.py:235", gj_single["launches"],
              gj_single["err"], gj_single["k_ms"], gj_single["p_ms"],
              single_bounds["gj"], gj_single["lib_ms"]),
        entry("run_kernel_wide", run_src,
              "toyspice_tpu/ops/pallas_run.py:652", run_wide["launches"],
              max(run_wide["err"], wide["promoted"]["err"]),
              run_wide["k_ms"], run_wide["p_ms"], wide_bounds["run"]),
        entry("op_kernel_wide", "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230", op_wide["launches"],
              max(op_wide["err"], wide["op_physics_err"]), op_wide["k_ms"],
              op_wide["p_ms"], wide_bounds["op"]),
        entry("run_kernel_wide_store", run_src,
              "toyspice_tpu/ops/pallas_tran.py:1429",
              wide["store"]["launches"], wide["store"]["err"],
              wide["store"]["k_ms"], wide["store"]["p_ms"],
              wide_bounds["store"]),
        entry("dc_sweep_kernel_wide",
              "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431",
              wide["dc_compat"]["launches"],
              max(wide["dc_compat"]["err"], wide["dc_physics"]["err"]),
              wide["dc_compat"]["k_ms"], wide["dc_compat"]["p_ms"],
              wide_bounds["dc"]),
    ] + [entry(f"run_kernel_wide_{key}", src_,
               "toyspice_tpu/ops/pallas_run.py:652", wide[key]["launches"],
               max(wide[key]["err"], wide["physics_be"]["err"])
               if key == "physics" else wide[key]["err"],
               wide[key]["k_ms"], wide[key]["p_ms"], wide_bounds[key])
         for key, src_ in (
             ("linear", run_src),
             ("physics", "toyspice_tpu_torch/csrc/run_kernel_phys.cu"),
             ("magnetic", run_src), ("physics_magnetic", mag_src),
             ("magnetic_newton", mag_src),
             ("physics_magnetic_newton", mag_src))] + [
        entry(f"run_kernel_block{'' if key == 'rc127' else '_' + key}",
              src_, repl, block[key]["launches"],
              max(block[key]["err"], block["physics_be"]["err"])
              if key == "physics" else block[key]["err"],
              block[key]["k_ms"], block[key]["p_ms"], block_bounds[key])
        for key, src_, repl in (
            ("rc127", run_src, "toyspice_tpu/ops/pallas_run.py:652"),
            ("linear", run_src, "toyspice_tpu/ops/pallas_run.py:652"),
            ("device_memory", run_src, "toyspice_tpu/ops/pallas_run.py:652"),
            ("newton", run_src, "toyspice_tpu/ops/pallas_run.py:652"),
            ("physics", "toyspice_tpu_torch/csrc/run_kernel_phys.cu",
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("magnetic", run_src, "toyspice_tpu/ops/pallas_run.py:652"),
            ("physics_magnetic", mag_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("magnetic_newton", mag_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("physics_magnetic_newton", mag_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("store", run_src, "toyspice_tpu/ops/pallas_tran.py:1429"))] + [
        entry("op_kernel_block", "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230", block["op"]["launches"],
              max(block["op"]["err"], block["op_physics_err"]),
              block["op"]["k_ms"], block["op"]["p_ms"], block_bounds["op"]),
        entry("dc_sweep_kernel_block",
              "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431",
              block["dc_compat"]["launches"],
              max(block["dc_compat"]["err"], block["dc_physics"]["err"]),
              block["dc_compat"]["k_ms"], block["dc_compat"]["p_ms"],
              block_bounds["dc_compat"])] + [
        entry(name, src_, repl, past[key]["launches"],
              past[key]["err"],
              past[key]["k_ms"], past[key]["p_ms"], past_bounds[key])
        for name, key, src_, repl in (
            ("run_kernel_nmos_ring101", "nmos", run_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("run_kernel_bus48", "bus", run_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("op_kernel_pv72", "pv_op",
             "toyspice_tpu_torch/csrc/op_kernel.cu",
             "toyspice_tpu/ops/pallas_op.py:230"),
            ("dc_sweep_kernel_pv72", "pv_dc",
             "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
             "toyspice_tpu/ops/pallas_op.py:431"),
            ("run_kernel_sources", "sources", run_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("run_kernel_physics_sources", "physics",
             "toyspice_tpu_torch/csrc/run_kernel_phys.cu",
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("run_kernel_magnetic_sources", "magnetic", run_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("run_kernel_physics_magnetic_sources", "physics_magnetic",
             mag_src, "toyspice_tpu/ops/pallas_run.py:652"),
            ("run_kernel_table_in_memory", "table", run_src,
             "toyspice_tpu/ops/pallas_run.py:652"),
            ("run_kernel_store_sources", "store", run_src,
             "toyspice_tpu/ops/pallas_tran.py:1429"),
            ("run_kernel_store_table", "store_table", run_src,
             "toyspice_tpu/ops/pallas_tran.py:1429"),
            ("op_kernel_table_in_memory", "op_table",
             "toyspice_tpu_torch/csrc/op_kernel.cu",
             "toyspice_tpu/ops/pallas_op.py:230"),
            ("dc_sweep_kernel_table_in_memory", "dc_table",
             "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
             "toyspice_tpu/ops/pallas_op.py:431"))]}
    phase("done", start, "all phases passed")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
