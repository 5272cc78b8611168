"""toyspice_tpu_torch: the PyTorch and CUDA port of toyspice_tpu.

It runs the batched SPICE engine of the JAX package ``toyspice_tpu`` on an
NVIDIA H100: the same netlist parser and circuit compiler (plain numpy
copies), parameters and state as dicts of f64 tensors with the batch axis
first, and hand-written CUDA kernels in ``csrc/`` in place of the Pallas
kernels.  The port imports neither JAX nor the JAX package.

Ported so far: the Monte-Carlo transient of linear compat decks (R, C, L, V,
I with DC, SIN, PULSE and PWL sources) with ``store='none'``, through one
whole-run kernel.  Entry points run on ``cuda`` unless given
``device="cpu"``; on the CPU the kernel's plain torch version runs instead.

    cc = compile_circuit(parse(deck))
    params, axes = batch_params(cc, overrides)
    fn = make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, init_state(cc))
"""

from .compiler import CompiledCircuit, compile_circuit  # noqa: F401
from .engine.batch import batch_params, make_tran_batch  # noqa: F401
from .engine.options import DEFAULTS, SimOptions  # noqa: F401
from .engine.state import init_state  # noqa: F401
from .engine.tran import TranConfig, TranOutput, build_config  # noqa: F401
from .netlist import parse  # noqa: F401

__version__ = "0.1.0"
