"""The port's example scripts (``hommx_tpu_torch/examples/``) against the JAX
examples (``examples/``) on the CPU, in float64, in one process: the HMM
examples held to a fine FEM (``hmm``, ``hmm_3d``, ``laminate``,
``inclusion``) and the command line.  ``test_torch_examples_cells.py``
holds the others with the helpers of this file.

Each test runs the JAX example's ``main()`` in-process, as ``__main__``
through ``runpy``, with its flags in ``sys.argv``, from ``tmp_path`` (some
write PNGs into the working directory), and reads what it prints; then it
runs the port's ``run`` on the same flags with ``device="cpu"``.  The two
outputs must print the same lines (numbers and file paths aside), and the
numbers agree within each test's tolerance.  Where the JAX example prints a
number rounded, the test reads the unrounded value from ``main``'s locals
(``_run_jax_example``'s ``names``)."""

import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

from hommx_tpu_torch.examples import hmm, hmm_3d
from hommx_tpu_torch.examples.diffusion import inclusion, laminate

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _run_jax_example(monkeypatch, capsys, tmp_path, rel: str, argv, names=()):
    """Run ``examples/<rel>`` as ``__main__`` with ``argv``; return its
    stdout and, for each of ``names``, the values that local of its
    ``main`` took, in order (read through ``sys.monitoring`` line events on
    ``main``'s code alone)."""
    path = str(REPO / "examples" / rel)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    monkeypatch.chdir(tmp_path)
    seen = {n: [] for n in names}
    mon = sys.monitoring
    tool = next(i for i in range(2, 6) if mon.get_tool(i) is None)
    mon.use_tool_id(tool, "test_torch_examples")

    def on_start(code, offset):
        if code.co_filename == path and code.co_name == "main":
            mon.set_local_events(tool, code, mon.events.LINE)
            return None
        return mon.DISABLE

    def on_line(code, line):
        local = sys._getframe(1).f_locals
        for n in names:
            if n in local and (not seen[n] or seen[n][-1] is not local[n]):
                seen[n].append(local[n])

    mon.register_callback(tool, mon.events.PY_START, on_start)
    mon.register_callback(tool, mon.events.LINE, on_line)
    if names:
        mon.set_events(tool, mon.events.PY_START)
    capsys.readouterr()
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        mon.set_events(tool, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.register_callback(tool, mon.events.LINE, None)
        mon.free_tool_id(tool)
        mon.restart_events()
    return capsys.readouterr().out, seen


def _run_port(capsys, fn, **kw):
    capsys.readouterr()
    result = fn(device="cpu", **kw)
    return result, capsys.readouterr().out


def _wording(text: str) -> list:
    """The printed lines with each number replaced by '#' and each path by
    its file name."""
    lines = []
    for line in text.splitlines():
        line = re.sub(r"\S*/(\S+)", r"\1", line)
        lines.append(re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", line))
    return lines


def _last_number(text: str) -> float:
    return float(re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", text.strip().splitlines()[-1])[-1])


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


# the JAX example beside the port's run
ERROR_CASES = {
    "hmm": ("hmm.py", hmm.run),
    "hmm_3d": ("hmm_3d.py", hmm_3d.run),
    "laminate": ("diffusion/laminate.py", laminate.run),
    "inclusion": ("diffusion/inclusion.py", inclusion.run),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_example_error_matches_jax(monkeypatch, capsys, tmp_path, name):
    """The --quick paths: the printed relative L² error of the HMM against
    its fine FEM within 1e-6 relative (cell dedup classes differ between
    the frameworks; u agrees to ~1e-8), the same printed lines, and the
    PNG where the example writes one."""
    rel_path, run = ERROR_CASES[name]
    jax_out, _ = _run_jax_example(monkeypatch, capsys, tmp_path, rel_path, ["--quick"])
    res, out = _run_port(capsys, run, quick=True, out=str(tmp_path / "port"))
    assert _wording(out) == _wording(jax_out)
    err_line = [ln for ln in jax_out.splitlines() if "error" in ln][-1]
    assert _rel(res["rel"], _last_number(err_line)) < 1e-6
    for png in res["pngs"]:
        assert Path(png).parent == tmp_path / "port"
        assert Path(png).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_example_cli_prints_the_jax_lines(capsys, tmp_path):
    """``main(argv)`` takes the example's flags plus --device and --out and
    prints the JAX example's lines."""
    res = inclusion.main(["--quick", "--plot", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("stratified HMM solve: ")
    assert out[1].startswith("fine FEM (128^2): ")
    assert out[2] == f"relative L^2 error is: {res['rel']}"
    assert out[3] == "wrote png"
    assert res["pngs"] == [str(tmp_path / "diffusion_wavy_inclusion_stratified_hmm.png")]
