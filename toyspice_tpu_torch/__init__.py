"""toyspice_tpu_torch: the PyTorch and CUDA port of toyspice_tpu.

It runs the batched SPICE engine of the JAX package ``toyspice_tpu`` on an
NVIDIA H100: the same netlist parser and circuit compiler (plain numpy
copies), parameters and state as dicts of f64 tensors with the batch axis
first, and hand-written CUDA kernels in ``csrc/`` in place of the Pallas
kernels.  The port imports neither JAX nor the JAX package.

Ported so far, compat semantics: the Monte-Carlo transient of decks of R,
C, L, V and I (DC, SIN, PULSE and PWL sources), diodes, BJTs and MOSFETs
with ``store='none'``, through one whole-run kernel (a nonlinear deck first
takes its operating point through the OP kernel); and the batched
operating point of nonlinear decks (``run_op_batch``), through the OP
kernel and the rescue ladders.  Entry points run on ``cuda`` unless given
``device="cpu"``; on the CPU the kernels' plain torch versions run instead.

    cc = compile_circuit(parse(deck))
    params, axes = batch_params(cc, overrides)
    fn = make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, init_state(cc))
    op = run_op_batch(cc, params, axes)
"""

from .compiler import CompiledCircuit, compile_circuit  # noqa: F401
from .engine.batch import (batch_params, make_tran_batch,  # noqa: F401
                           run_op_batch)
from .engine.options import DEFAULTS, SimOptions  # noqa: F401
from .engine.state import init_state  # noqa: F401
from .engine.tran import TranConfig, TranOutput, build_config  # noqa: F401
from .netlist import parse  # noqa: F401

__version__ = "0.1.0"
