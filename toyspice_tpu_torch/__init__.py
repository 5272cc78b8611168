"""toyspice_tpu_torch: the PyTorch and CUDA port of toyspice_tpu.

It runs the batched SPICE engine of the JAX package ``toyspice_tpu`` on an
NVIDIA H100: the same netlist parser and circuit compiler (plain numpy
copies), parameters and state as dicts of f64 tensors with the batch axis
first, and hand-written CUDA kernels in ``csrc/`` in place of the Pallas
kernels.  The port imports neither JAX nor the JAX package.

Ported so far, for decks of R, C, L, V and I (DC, SIN, PULSE and PWL
sources), diodes, BJTs and MOSFETs, under compat semantics and under
physics semantics (``semantics="physics"``: backward Euler or, with
``SimOptions(integration="trap")``, the trapezoidal rule; a physics run
starts at its bias point): the Monte-Carlo transient through one whole-run
kernel (a nonlinear deck first takes its operating point through the OP
kernel), also for magnetic inductors and mutual couplings under compat;
with ``store='full'`` the kernel's store instantiation returns every
accepted step, whole (``make_tran_batch``) or in chunks of bounded size
(``stream_transient_chunks``, ``run_transient_streamed``), and a run
resumes from a checkpoint (``resume=True``,
``save_checkpoint``/``load_checkpoint``, files the JAX package reads too);
the batched operating point (``run_op_batch``), through the OP kernel and
the rescue ladders, or on a linear deck the stamped-solve kernel under the
same ladders; the DC sweep (``run_dc_batch``), through the DC sweep kernel
or the stamped solve; and AC (``run_ac_batch``), that operating point and
then the AC kernel.  A deck past the kernels' caps (np1 > 32, more than 32
sources, more than 16 diodes, BJTs and MOSFETs) takes the general engine
(engine "general"): the JAX package's batched Newton, OP ladder,
transient, DC sweep and AC as host loops over per-lane masks, each Newton
iteration one assembly and one launch of the stamped solve (a warp or a
block per lane past np1 = 32; past 128 the system in device memory), the
dense solves (the OP's seed, the AC systems) the GJ kernel, for decks of
any np1.  Entry points run on ``cuda``
unless given ``device="cpu"``; on the CPU the kernels' plain torch
versions run instead.

The JAX package's user surface runs one instance of a deck as a batch of
one through the general engine (``run_op``, ``run_transient``, ``run_ac``,
``run_dc``, ``run_analysis`` returning ``Results``), and its command line
is ``python -m toyspice_tpu_torch deck.cir`` (``cli.py``: the same tables,
``--engine xla|host|host-native``, ``--platform cuda|cpu``); the host
engines (``hostsim``, ``native``), ``debug`` and ``utils.profiling`` are
there too.  The JAX package's engine overrides (``TOYSPICE_TRAN``,
``TOYSPICE_TRAN_RUN``, ``TOYSPICE_OP``, ``TOYSPICE_AC``,
``TOYSPICE_SOLVER``, ``TOYSPICE_TRAN_IMPL``) choose among the port's
engines and between the kernels and their plain versions
(``engine/batch.py``, ``ops/solve.py``).

``parallel`` shards a Monte-Carlo batch over a mesh of devices
(``parallel/mesh.py``: ``run_transient_sharded``, ``run_op_sharded``,
``run_dc_sharded``, ``run_ac_sharded`` over a batch x frequency mesh; a
host thread a card, each shard the batch API's own engine), and
``parallel/dryrun.py`` and ``examples/`` are the JAX package's graft entry
and programmatic-API examples.

    r = run_analysis("circuits/half_wave_rectifier.cir")  # on the card
    r["TIME"], r["V(dcout)"]

    cc = compile_circuit(parse(deck))
    params, axes = batch_params(cc, overrides)
    fn = make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, init_state(cc))
    for chunk in stream_transient_chunks(cc, cfg, params, init_state(cc),
                                         chunk_store=4096):
        ...  # chunk.out_x[:, :chunk.out_n.max()] on the card
    op = run_op_batch(cc, params, axes)
    xs, conv = run_dc_batch(cc, (0,), params, axes, points)
    xr, xi, opr = run_ac_batch(cc, params, axes, freqs)
"""

from .consts import BOLTZMANN, CHARGE, KELVIN  # noqa: F401
from .compiler import CompiledCircuit, compile_circuit  # noqa: F401
from .engine import (run_ac, run_analysis, run_dc, run_op,  # noqa: F401
                     run_transient)
from .engine.ac import frequency_points, make_ac  # noqa: F401
from .engine.batch import (batch_params, make_tran_batch,  # noqa: F401
                           make_tran_stream, run_ac_batch, run_dc_batch,
                           run_op_batch, run_transient_batch,
                           run_transient_streamed, stream_transient_chunks)
from .engine.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .engine.dc import make_dc, sweep_values  # noqa: F401
from .engine.op import make_op  # noqa: F401
from .engine.options import DEFAULTS, SimOptions  # noqa: F401
from .engine.state import init_state  # noqa: F401
from .engine.tran import (TranConfig, TranOutput, build_config,  # noqa: F401
                          make_tran)
from .netlist import (AnalysisType, Element, ModelParam,  # noqa: F401
                      NetlistData, parse, parse_value)

__version__ = "0.1.0"
