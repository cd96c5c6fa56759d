"""The four examples on the port (``examples/*_torch.py``) run on the CPU
at a tiny size and print their tables."""

from __future__ import annotations

import importlib.util
import math
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

# script → (tiny-size arguments, lines its output must hold)
CASES = {
    "quickstart_torch": (
        ["--scale", "0.05", "--rounds", "2"],
        ["strategy    peak acc", "\nD ", "\nE ", "\nOPP ",
         "Expected ordering (paper Fig. 6a)"]),
    "train_federated_e2e_torch": (
        ["--scale", "0.05", "--rounds", "2", "--clients", "2"],
        ["=== strategy E:", "=== strategy OPG:", "  round   1 acc=",
         "=== summary", "\nE    peak=", "\nOPG  peak="]),
    "serve_llm_torch": (
        ["--batch", "2", "--prompt", "3", "--generate", "2"],
        ["CPU, reduced configs", "smollm-360m", "mamba2-1.3b",
         "deepseek-v2-lite-16b", "tok/s"]),
    "federated_llm_torch": (
        ["--rounds", "2", "--local-steps", "1", "--seq", "8"],
        ["2 silos x 1 local steps", "\ndense ", "\npruned ", "\nstale ",
         "MiB shipped/round"]),
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _finite(x) -> bool:
    return all(math.isfinite(v) for v in x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, one_thread, capsys):
    args, wants = CASES[name]
    out = _load(name).main(args + ["--device", "cpu"])
    text = capsys.readouterr().out
    for want in wants:
        assert want in text, (want, text)
    if name in ("quickstart_torch", "train_federated_e2e_torch"):
        assert list(out) == (["D", "E", "OPP"] if name == "quickstart_torch"
                             else ["E", "OPG"])
        for stats in out.values():
            assert len(stats) == 2
            assert _finite([s.train_loss for s in stats])
            assert all(0.0 <= s.accuracy <= 1.0 for s in stats)
    elif name == "serve_llm_torch":
        assert len(out) == 3 and all(v > 0 for v in out.values())
    else:
        assert list(out) == ["dense", "pruned", "stale"]
        assert all(len(v) == 2 and _finite(v) for v in out.values())
