"""Multi-card scaling: shard the Monte-Carlo batch axis over a mesh of
devices (parallel/mesh.py of the JAX package).

Per-instance circuits are tiny, so the parallelism across cards is data
parallel over the batch axis: each device runs the batch API's engine on
its contiguous slice of the lanes, with nothing exchanged per attempt, and
the only collective is the sum of the accepted-step counts.  AC can shard
its frequency grid over a second mesh axis as well.

The JAX module is one controller over its mesh, and so is this one: no
process group.  ``Mesh`` holds the devices, always indexed (``cuda:i`` or
``cpu``); a device may appear more than once, as the JAX tests' virtual
CPU devices do, and shards that share a device run in turn.  A call runs
one host thread per distinct device, with that device current (the kernel
wrappers launch on their tensors' device and release the interpreter lock
in ``ctypes``); an exception in a thread is raised again in the caller.
Each shard runs exactly the unsharded batch API's engine on its lanes, and
a lane's arithmetic never depends on the other lanes of its batch, so a
sharded result equals the unsharded one bit for bit.  The gather is plain
copies onto the mesh's first device.
"""

import concurrent.futures
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..engine.options import DEFAULTS
from ..engine.state import init_state
from ..engine.tran import TranConfig


@dataclass(frozen=True, eq=False)
class Mesh:
    """An n-D grid of ``torch.device`` and the names of its axes (the JAX
    ``Mesh``'s ``devices`` and ``axis_names``).  Each device is indexed:
    ``cuda:i`` or ``cpu``."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        grid = np.array(self.devices, dtype=object)
        devs = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            dev = torch.device(grid[pos])
            if dev.type == "cuda" and dev.index is None:
                raise ValueError("a mesh holds indexed devices (cuda:i), "
                                 f"got {dev}")
            devs[pos] = dev
        names = tuple(self.axis_names)
        if devs.size == 0 or len(names) != devs.ndim:
            raise ValueError(f"a mesh of shape {devs.shape} needs one name "
                             f"per axis and a device, got axes {names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"the mesh has no axis {name!r} (axes "
                             f"{self.axis_names})")
        return self.axis_names.index(name)

    def first(self) -> torch.device:
        """The device results are gathered on."""
        return self.devices.flat[0]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> Mesh:
    """A 1-D mesh of ``cuda:0`` .. ``cuda:n-1`` (all the cards when
    ``n_devices`` is None); it raises RuntimeError when fewer cards are
    present, and never repeats one.  ``device="cpu"`` gives ``n_devices``
    CPU shards (default 1)."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        devs = [torch.device("cpu")] * n
    elif kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else int(n_devices)
        if have == 0 or have < n:
            raise RuntimeError(
                f"make_mesh: asked for {n_devices or 'every'} CUDA device(s) "
                f"but {have} are present; for CPU shards pass device='cpu', "
                "and for several shards on one card build a Mesh of it "
                "repeated")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"make_mesh: device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be at least 1, got {n}")
    return Mesh(np.array(devs, dtype=object), (axis,))


def make_mesh_2d(shape, axes=("data", "sweep"), device="cuda") -> Mesh:
    """2-D device mesh: Monte-Carlo batch on one axis, an analysis sweep
    (AC frequencies) on the other."""
    rows, cols = (int(s) for s in shape)
    mesh = make_mesh(rows * cols, device=device)
    return Mesh(mesh.devices.reshape(rows, cols), tuple(axes))


def _batch(params, in_axes) -> int:
    sizes = {int(torch.as_tensor(leaf).shape[0])
             for kind, tbl in params.items() for key, leaf in tbl.items()
             if in_axes[kind][key] == 0}
    if len(sizes) != 1:
        raise ValueError("the batched leaves (in_axes 0) must share one "
                         f"leading size, got {sorted(sizes) or 'none'}")
    return sizes.pop()


def shard_batch(mesh: Mesh, params, in_axes, axis: str = "data"):
    """Each device's parameters: a leaf with ``in_axes`` 0 split along
    dim 0 into one contiguous slice per position on ``axis``, every other
    leaf copied to every device.  Returns an object array of the mesh's
    shape whose entry at a device's position is its parameter dict.  A
    batch the axis does not divide evenly raises ValueError, as the JAX
    package does."""
    k = mesh.axis(axis)
    n = mesh.devices.shape[k]
    b = _batch(params, in_axes)
    if b % n:
        raise ValueError(f"shard_batch: a batch of {b} does not split "
                         f"evenly over the {n} positions of axis {axis!r}")
    s = b // n
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(mesh.devices.shape):
        lo, dev = pos[k] * s, mesh.devices[pos]
        out[pos] = {kind: {key: (torch.as_tensor(leaf)[lo:lo + s]
                                 if in_axes[kind][key] == 0 else
                                 torch.as_tensor(leaf)).to(dev)
                           for key, leaf in tbl.items()}
                    for kind, tbl in params.items()}
    return out


def _grid(mesh: Mesh, axes):
    """The positions that carry the work, one for each coordinate along
    ``axes`` (an object array of those axes' shape); the mesh's other
    axes stay at 0, since their devices would hold copies of it."""
    ks = [mesh.axis(a) for a in axes]
    grid = np.empty(tuple(mesh.devices.shape[k] for k in ks), dtype=object)
    for coords in np.ndindex(grid.shape):
        pos = [0] * mesh.devices.ndim
        for k, i in zip(ks, coords):
            pos[k] = i
        grid[coords] = tuple(pos)
    return grid


def _run(mesh: Mesh, positions, work):
    """{position: work(position, device)} for the given positions: one
    thread per distinct device, with that device current, running its
    positions in order; the first exception of a thread is raised here."""
    by_device = {}
    for pos in positions:
        by_device.setdefault(mesh.devices[pos], []).append(pos)
    results = {}

    def on(device, mine):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        for pos in mine:
            results[pos] = work(pos, device)

    with concurrent.futures.ThreadPoolExecutor(len(by_device)) as pool:
        futures = [pool.submit(on, dev, mine)
                   for dev, mine in by_device.items()]
        for fut in futures:
            fut.result()
    return results


def _gather(parts, device, dim=0):
    """The shards' results (tensors, dicts, tuples, NamedTuples or None, of
    one structure) joined along ``dim`` on ``device``, in order."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts], dim=dim)
    if isinstance(first, dict):
        return {key: _gather([p[key] for p in parts], device, dim)
                for key in first}
    if isinstance(first, tuple):
        fields = [_gather([p[i] for p in parts], device, dim)
                  for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else \
            tuple(fields)
    raise TypeError(f"cannot gather {type(first).__name__}")


def _same_bits(a, b) -> bool:
    """Equal structure and equal bits (NaNs, signed zeros included)."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}
            ints = bits[a.element_size()]
            return torch.equal(a.contiguous().view(ints),
                               b.contiguous().view(ints))
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_bits(x, y)
                                        for x, y in zip(a, b))
    return a is None and b is None


def _shard_along(mesh, params, in_axes, axis, work):
    """Run work(params, device) on each position of ``axis`` and return
    the results in lane order."""
    shards = shard_batch(mesh, params, in_axes, axis)
    grid = _grid(mesh, (axis,))
    res = _run(mesh, list(grid), lambda pos, dev: work(shards[pos], dev))
    return [res[pos] for pos in grid]


def run_op_sharded(cc, mesh: Mesh, params, in_axes, axis: str = "data",
                   opts=None, semantics: str = "compat"):
    """Batched operating point sharded over the mesh's batch axis: each
    shard runs the engine ``engine/batch.make_op_engine`` picks, as the
    unsharded ``run_op_batch`` does (the OP kernel under the rescue
    ladders, the linear OP or the general engine), on its lanes.  The
    chosen engine is recorded on ``run_op_sharded.last_engine`` and
    ``.last_reason``."""
    from ..engine.batch import make_op_engine

    opts = opts if opts is not None else DEFAULTS
    engine, reason, fn = make_op_engine(cc, opts, semantics)
    parts = _shard_along(mesh, params, in_axes, axis, lambda p, dev: fn(
        p, init_state(cc, device=dev)))
    out = _gather(parts, mesh.first())
    run_op_sharded.last_engine = engine
    run_op_sharded.last_reason = reason
    return out


def run_dc_sharded(cc, src_slots, mesh: Mesh, params, in_axes, points,
                   axis: str = "data", opts=None, semantics: str = "compat"):
    """Batched DC sweep sharded over the mesh's batch axis.  The sweep
    points are copied to every device and stay sequential per lane (each
    point warm-starts Newton from the previous solution, so, unlike AC
    frequencies, points cannot shard onto a second mesh axis without
    changing convergence).  Returns (xs (B, P, np1), conv (B, P)); engine
    dispatch (``engine/batch.make_dc_engine``, as ``run_dc_batch``) and
    recording as in ``run_op_sharded``."""
    from ..engine.batch import make_dc_engine

    opts = opts if opts is not None else DEFAULTS
    engine, reason, fn = make_dc_engine(cc, tuple(src_slots), opts,
                                        semantics)
    pts = torch.as_tensor(points, dtype=torch.float64)
    parts = _shard_along(mesh, params, in_axes, axis, lambda p, dev: fn(
        p, init_state(cc, device=dev), pts.to(dev)))
    out = _gather(parts, mesh.first())
    run_dc_sharded.last_engine = engine
    run_dc_sharded.last_reason = reason
    return out


def run_ac_sharded(cc, mesh: Mesh, params, in_axes, freqs,
                   batch_axis: str = "data", sweep_axis: str = "sweep",
                   opts=None, semantics: str = "compat"):
    """Batched AC over a 2-D mesh: Monte-Carlo instances shard over the
    batch axis, the frequency grid over the sweep axis; device (i, j) runs
    ``engine/ac.make_ac_batch`` (the engine of ``run_ac_batch``) on batch
    slice i and frequency slice j.  Returns (xr, xi, opr) with xr, xi
    (B, F, np1) and opr the bias of sweep column 0; every column's bias
    must equal column 0's bit for bit (RuntimeError otherwise).  A grid the
    sweep axis does not divide evenly raises ValueError."""
    from ..engine.ac import make_ac_batch

    opts = opts if opts is not None else DEFAULTS
    fn = make_ac_batch(cc, in_axes, opts, semantics=semantics)
    f = np.asarray(freqs.cpu() if isinstance(freqs, torch.Tensor) else freqs,
                   dtype=np.float64)
    ks = mesh.axis(sweep_axis)
    nsw = mesh.devices.shape[ks]
    if len(f) % nsw:
        raise ValueError(f"run_ac_sharded: {len(f)} frequencies do not "
                         f"split evenly over the {nsw} positions of axis "
                         f"{sweep_axis!r}")
    fs = len(f) // nsw
    shards = shard_batch(mesh, params, in_axes, batch_axis)
    grid = _grid(mesh, (batch_axis, sweep_axis))

    def work(pos, dev):
        j = pos[ks]
        return fn(shards[pos], init_state(cc, device=dev),
                  f[j * fs:(j + 1) * fs])

    res = _run(mesh, list(grid.flat), work)
    dev0 = mesh.first()
    rows = [[res[pos] for pos in row] for row in grid]
    for i, row in enumerate(rows):
        for j, (_, _, opr) in enumerate(row[1:], 1):
            if not _same_bits(_gather([opr], row[0][2].x.device),
                              row[0][2]):
                raise RuntimeError(
                    f"run_ac_sharded: the bias of batch slice {i} differs "
                    f"between sweep columns 0 and {j}")
    xr = _gather([_gather([r[0] for r in row], dev0, dim=1)
                  for row in rows], dev0)
    xi = _gather([_gather([r[1] for r in row], dev0, dim=1)
                  for row in rows], dev0)
    opr = _gather([row[0][2] for row in rows], dev0)
    return xr, xi, opr


def run_transient_sharded(cc, cfg: TranConfig, mesh: Mesh, params, in_axes,
                          semantics: str = "compat", axis: str = "data",
                          store: str = "none", opts=None):
    """The batched transient sharded over the mesh's batch axis.  Returns
    the batched ``TranOutput`` (each per-lane leaf in lane order on the
    mesh's first device) and the summed accepted-step count, a 0-d int64
    tensor there.

    Dispatches through ``engine/batch.select_tran_engine`` exactly as the
    unsharded batch API does, so an eligible run gets the whole-run kernel
    on every shard (the per-shard engine is the same; only the lane slice
    differs), and each shard's run ends with its own lanes.  The engine is
    recorded on ``run_transient_sharded.last_engine`` and
    ``.last_reason``."""
    from ..engine.batch import select_tran_engine

    opts = opts if opts is not None else DEFAULTS
    engine, reason, fn = select_tran_engine(
        cc, cfg, in_axes, semantics=semantics, store=store, opts=opts)

    def step(p, dev):
        out = fn(p, init_state(cc, device=dev))
        return out, out.accepted.sum()

    parts = _shard_along(mesh, params, in_axes, axis, step)
    dev0 = mesh.first()
    out = _gather([o for o, _ in parts], dev0)
    total = torch.stack([s.to(dev0) for _, s in parts]).sum()
    run_transient_sharded.last_engine = engine
    run_transient_sharded.last_reason = reason
    return out, total
