"""rl_tran.cir through both command lines on the CPU: its tables and its
Results against the JAX package's (test_torch_cli.tables_and_results).
One of the three 20,000-step transients of ``circuits/``, each in a file
of its own for the time the port's general engine takes on a CPU."""

from test_torch_cli import tables_and_results


def test_rl_tran_matches_jax(monkeypatch):
    tables_and_results("rl_tran.cir", monkeypatch)
