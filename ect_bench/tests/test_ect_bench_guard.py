"""No JAX in a run: the module check the run makes after set-up and after
the window, a run on the CPU that loads none, and files it never reads."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from ect_bench import harness, registry

REPO = registry.HERE.parent
# the JAX-era benchmark files the port's benchmark must not read
NOT_READ = re.compile(r"(^|[\s\"'/(])(bench\.py|bench_configs\.py|"
                      r"policy_sweep\.py|BENCH_r\d*[^\s\"']*\.json|"
                      r"MULTICHIP_r\d*[^\s\"']*\.json|BASELINE\.json)")


@pytest.mark.parametrize("names,found", [
    (["numpy", "torch.cuda", "entropy_coders_tpu_torch.frame"], []),
    (["jax"], ["jax"]),
    (["jaxlib.xla_client", "os"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["entropy_coders_tpu.frame", "entropy_coders_tpu_torch"],
     ["entropy_coders_tpu"]),
    (["jaxtyping", "entropy_coders_tpu_torchx"], []),
])
def test_forbidden_names_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_raises_when_a_forbidden_module_is_loaded(tmp_path,
                                                        monkeypatch):
    from ect_bench.tests.tiny import make_root

    root, bench = make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(harness.ForbiddenModules):
        harness.run_cell(bench, registry.cell(bench, "tiny_pl.roundtrip"), 1,
                         0.2, False, "cpu", root=root, log=lambda s: None)


def test_a_cpu_run_loads_no_jax_and_reads_no_jax_era_file(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str) else None)
from ect_bench import harness, registry
from ect_bench.tests.tiny import make_root
root, bench = make_root({str(tmp_path)!r})
res = harness.run_cell(bench, registry.cell(bench, "tiny.range_reads"), 3,
                       0.3, True, "cpu", root=root, log=lambda s: None)
print(json.dumps({{"bad": harness.forbidden_modules(), "opened": opened,
                  "correct": res["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["correct"] and got["bad"] == []
    assert not [p for p in got["opened"] if NOT_READ.search(p)]


def test_the_harness_sources_name_no_jax_era_file():
    for path in registry.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert not NOT_READ.search(text), path
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                             r"entropy_coders_tpu)\b(?!_torch)", text,
                             re.M), path


def test_the_run_refuses_without_cuda_and_prints_no_result(tmp_path):
    """Without a card (this machine), or in a directory that holds only the
    benchmark's files, the run exits non-zero and prints nothing on its
    standard output."""
    bare = tmp_path / "bare"
    shutil.copytree(registry.HERE, bare / "ect_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", bare)
    for cwd in (REPO, bare):
        p = subprocess.run([sys.executable, "-m", "ect_bench.run",
                            "--workload", "bench_pl_128m.roundtrip",
                            "--seed", str(2**31 + 7), "--seconds", "1",
                            "--trace", "0"], capture_output=True, text=True,
                           cwd=cwd)
        assert p.returncode != 0 and p.stdout == ""
