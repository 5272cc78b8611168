"""Command-line entry point: ``python -m toyspice_tpu_torch <netlist.cir>``.

The port's counterpart of the JAX package's cli.py.  Mirrors the reference
CLI's result tables (cmd/spice/main.go:17-185): AC, DC-sweep,
operating-point and transient formats with the same engineering notation
and column conventions.  The default engine, ``xla`` as the JAX package
names it, is the port's: the general engine with the stamped-solve and GJ
kernels on the card (``--platform cuda``, the default), or their plain
torch versions on the CPU (``--platform cpu``).
"""

import argparse
import sys

from .engine import run_analysis
from .utils.formatter import (
    format_frequency,
    format_magnitude,
    format_phase,
    format_value_factor,
)


def print_results(results, out=None):
    # resolve stdout at call time (an import-time default would pin whatever
    # stream was active when the module first loaded, e.g. a test capture)
    w = (out or sys.stdout).write
    w("\nAnalysis Results:\n")
    w("================\n")

    # AC
    if "FREQ" in results:
        freqs = results["FREQ"]
        w(f"\nAC Analysis Results ({len(freqs)} frequency points):\n")
        w("Frequency      Node Voltages (Magnitude/Phase)        "
          "Branch Currents (Magnitude/Phase)\n")
        w("-" * 77 + "\n")
        vnames = sorted(
            n[: -len("_MAG")] for n in results
            if n.endswith("_MAG") and n.startswith("V(")
        )
        inames = sorted(
            n[: -len("_MAG")] for n in results
            if n.endswith("_MAG") and n.startswith("I(")
        )
        for i, f in enumerate(freqs):
            w(f"{format_frequency(f):<13s}")
            for name in vnames + inames:
                mag = format_magnitude(results[name + "_MAG"][i])
                ph = format_phase(results[name + "_PHASE"][i])
                w(f"{name}={mag}<{ph}deg  ")
            w("\n")
        return

    # DC sweep
    if "SWEEP1" in results:
        sweep1 = results["SWEEP1"]
        w(f"\nDC Sweep Analysis Results ({len(sweep1)} points):\n")
        w("Sweep Values    Node Voltages        Branch Currents\n")
        w("-" * 48 + "\n")
        vnames = sorted(n for n in results if n.startswith("V("))
        inames = sorted(n for n in results if n.startswith("I("))
        nested = "SWEEP2" in results
        for i in range(len(sweep1)):
            if nested:
                w(f"V1={format_value_factor(sweep1[i], 'V'):<9s} "
                  f"V2={format_value_factor(results['SWEEP2'][i], 'V'):<9s}  ")
            else:
                w(f"V={format_value_factor(sweep1[i], 'V'):<9s}  ")
            for name in vnames:
                w(f"{name}={format_value_factor(results[name][i], 'V')}  ")
            for name in inames:
                w(f"{name}={format_value_factor(results[name][i], 'A')}  ")
            w("\n")
        return

    # operating point
    if len(results.get("TIME", [])) <= 1:
        vnames = sorted(n for n in results if n.startswith("V("))
        inames = sorted(n for n in results if n.startswith("I("))
        w("\nNode Voltages:\n")
        for name in vnames:
            w(f"{name} = {format_value_factor(results[name][0], 'V')}\n")
        w("\nBranch Currents:\n")
        for name in inames:
            w(f"{name} = {format_value_factor(results[name][0], 'A')}\n")
        return

    # transient
    times = results["TIME"]
    w(f"\nTransient Analysis Results ({len(times)} time points):\n")
    w("Time        Node Voltages        Branch Currents\n")
    w("-" * 48 + "\n")
    vnames = sorted(n for n in results if n.startswith("V("))
    inames = sorted(n for n in results if n.startswith("I("))
    for i, t in enumerate(times):
        w(f"{format_value_factor(t, 's'):>9s}  ")
        for name in vnames:
            w(f"{name}={format_value_factor(results[name][i], 'V')}  ")
        for name in inames:
            w(f"{name}={format_value_factor(results[name][i], 'A')}  ")
        w("\n")


def _run(src, engine: str, semantics: str = "compat", device="cuda"):
    if engine in ("host", "host-native"):
        if semantics != "compat":
            raise RuntimeError(
                "the host engines implement compat semantics only "
                "(they are the reference-behavior parity oracle); "
                "use --engine xla for --semantics physics")
        from .compiler import compile_circuit
        from .hostsim import run_host_analysis, set_solver
        from .netlist.parser import parse

        set_solver("native" if engine == "host-native" else "numpy")
        cc = src if not isinstance(src, str) else compile_circuit(parse(src))
        return run_host_analysis(cc)
    return run_analysis(src, semantics=semantics, device=device)


def _engine_line(device):
    """The verbose header's engine line: which engine and kernels run."""
    from .engine.overrides import solver_backend

    backend = solver_backend()
    if device == "cuda" and backend != "xla":
        how = ("the stamped-solve kernel (csrc/stamped_solve.cu) for every "
               "Newton iteration and the GJ kernel (csrc/gj_kernel.cu) for "
               "the dense solves, on the card")
    else:
        how = (f"the plain torch versions of the stamped-solve and GJ "
               f"kernels, on {device}")
    return (f"engine: xla (solver backend: {backend}; single-instance runs "
            f"use the general engine: {how}; the whole-run, OP, DC sweep "
            "and AC kernels serve the batch API, see engine/batch.py)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="tspice",
        description="SPICE circuit simulator (toy-spice capabilities), the "
                    "PyTorch and CUDA port of toyspice_tpu",
    )
    parser.add_argument("netlist", help="netlist file (.cir)")
    parser.add_argument(
        "-v", "--verbose", action="store_true",
        help="print the parse report, per-element expected stamps and the "
             "assembled MNA system before solving (the reference CLI's "
             "procWithPrintSystem pipeline)",
    )
    parser.add_argument(
        "--engine",
        choices=["xla", "host", "host-native"],
        default="xla",
        help="xla (default, the JAX package's name): the port's engine, "
             "the general engine over the hand-written kernels on the card "
             "(their plain torch versions with --platform cpu).  host: the "
             "sequential host engine (no kernel build — milliseconds for a "
             "one-shot run).  host-native: host engine solving through the "
             "C++ sparse LU (native/sparse_lu.cc).",
    )
    parser.add_argument(
        "--semantics",
        choices=["compat", "physics"],
        default="compat",
        help="compat (default): reproduce the Go reference's observable "
             "behavior, quirks included (PLAN.md).  physics: the corrected "
             "variant (live J-A hysteresis, diode Rs/Bv, committed device "
             "charge memory; combine with trapezoidal integration via the "
             "library API).  xla engine only.",
    )
    parser.add_argument(
        "--debug-nans",
        action="store_true",
        help="abort with a traceback at the first non-finite x that a "
             "solve of the general engine returns (the port's counterpart "
             "of jax_debug_nans; one host sync a solve).  For debugging "
             "non-convergence, not for normal runs — the rescue ladders "
             "legitimately pass through non-finite intermediate solves.",
    )
    parser.add_argument(
        "--platform",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device of the solve.  Default cuda: the hand-written kernels "
             "on the card; without a card the run stops with an error (it "
             "does not carry on on the CPU).  cpu: the kernels' plain torch "
             "versions.  The Monte-Carlo batch API "
             "(toyspice_tpu_torch.engine.batch) is where thousands of "
             "instances share each launch.",
    )
    args = parser.parse_args(argv)

    if args.platform == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("Error: --platform cuda, but torch.cuda.is_available() is "
                  "false (no CUDA card); use --platform cpu",
                  file=sys.stderr)
            return 1
    from .ops.solve import debug_nans

    debug_nans(args.debug_nans)

    try:
        with open(args.netlist) as f:
            text = f.read()
    except OSError as e:
        print(f"Error reading netlist file: {e}", file=sys.stderr)
        return 1

    try:
        if args.verbose:
            from .compiler import compile_circuit
            from .netlist.parser import parse
            from . import debug

            print(f"\n[1] Reading netlist file: {args.netlist}")
            print(f"File contents:\n{text}")
            print("\n[2] Parsing netlist")
            cc = compile_circuit(parse(text))
            debug.print_parse_report(cc)
            print("\n[3] Creating circuit structure")
            debug.print_element_details(cc)
            debug.print_system(cc, device=args.platform)
            print("\n[4] Running analysis")
            if args.engine == "xla":
                print(_engine_line(args.platform))
            else:
                print(f"engine: {args.engine}")
            results = _run(cc, args.engine, args.semantics, args.platform)
        else:
            results = _run(text, args.engine, args.semantics, args.platform)
    except Exception as e:
        print(f"Analysis failed: {e}", file=sys.stderr)
        return 1

    print_results(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
