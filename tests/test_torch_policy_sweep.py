"""The port's table-log policy sweep (``entropy_coders_tpu_torch.tools.
policy_sweep``) against the root ``policy_sweep.py`` and the JAX package's
``normalize``, on the CPU.

The root script is read, not imported: importing it enables the JAX
compile cache and imports the root ``bench``. Its sets (``CONFIGS``,
``POLICIES``, ``LS``, ``SIZE``), its row's keys and its effective-rate
expression are taken from its syntax tree; the expression is evaluated as
written on fixed inputs. The rates are device numbers, so on the CPU they
are given, never measured. Tolerance: exact (the logs are integers; the
effective rate is the same float expression in the same order)."""

import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from entropy_coders_tpu.normalize import normalize_batch as jax_normalize  # noqa: E402
import entropy_coders_tpu_torch as T  # noqa: E402
from entropy_coders_tpu_torch.tools import bench_configs as BC  # noqa: E402
from entropy_coders_tpu_torch.tools import policy_sweep as PS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MIB = 1 << 20


@pytest.fixture(scope="module")
def root_tree():
    return ast.parse((ROOT / "policy_sweep.py").read_text())


def _assigned(tree, name):
    """The value node assigned to ``name`` anywhere in ``tree``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return node.value
    raise LookupError(name)


@pytest.fixture(scope="module")
def corpora_1mib():
    c = BC.Corpora()
    return {name: c.get(name, MIB) for name in PS.CORPORA}


def test_sets_equal_root(root_tree):
    for name in ("CONFIGS", "POLICIES", "LS", "SIZE"):
        node = ast.Expression(_assigned(root_tree, name))
        want = eval(compile(node, "policy_sweep.py", "eval"),
                    {"__builtins__": {}})
        assert getattr(PS, name) == want, name


@pytest.mark.parametrize("corpus", PS.CORPORA)
@pytest.mark.parametrize("pname,policy", PS.POLICIES,
                         ids=[p for p, _ in PS.POLICIES])
def test_chosen_logs_equal_jax(pname, policy, corpus, corpora_1mib):
    """1 MiB of each corpus at 128 KiB blocks: the logs each policy picks
    equal the JAX package's ``normalize_batch`` on the same counts."""
    data = corpora_1mib[corpus]
    cfg = PS.CONFIGS["default"]
    bs = cfg["block_size"]
    counts = np.stack([np.bincount(b, minlength=256)
                       for b in data.reshape(-1, bs)])
    got = PS.chosen_logs(data, cfg, policy)
    assert got.tolist() == jax_normalize(counts, bs, policy)[1].tolist()
    assert len(got) == MIB // bs


@pytest.mark.parametrize("log2s,n_bytes", [
    ([8, 8, 9, 11, 11, 11], 6 * 4096),
    ([10, 12, 7, 10], 4 * 4096 + 777),  # logs without a rate; a tail
    ([9], 4096)])
def test_eff_rate_equals_root_expression(log2s, n_bytes, root_tree):
    """The root's own expression (``policy_sweep.py:118-121``) on fixed
    inputs."""
    rates = {8: 412.5, 9: 371.25, 10: 300.0, 11: 201.75}
    uniq, cnt = np.unique(np.array(log2s), return_counts=True)
    expr = ast.Expression(_assigned(root_tree, "eff"))
    eff = eval(compile(expr, "policy_sweep.py", "eval"),
               {"data": np.zeros(n_bytes, np.uint8), "bs": 4096,
                "rates": rates, "uniq": uniq, "cnt": cnt, "LS": PS.LS})
    assert PS.eff_decode_gbps(n_bytes, log2s, 4096, rates) == eff / 1e9


def test_row_has_root_keys(root_tree, monkeypatch):
    """A row at a tiny size on the CPU, its rates given."""
    keys = [k.value for k in _assigned(root_tree, "row").keys]
    monkeypatch.setitem(PS.CONFIGS, "default", {"block_size": 16384,
                                                "k": 256})
    data = BC.Corpora().get("geo", 4 * 16384)
    rates = {8: 4.0, 9: 3.0, 10: 2.0, 11: 1.0}
    row = PS.sweep_row("default", "geo", data, "fast_p25", ("fast", 0.0025),
                       rates, device="cpu")
    assert list(row) == keys
    frame = T.compress(data, block_size=16384, k=256, lanes=True,
                       table_log=("fast", 0.0025), device="cpu")
    assert row["ratio"] == len(frame) / len(data)
    logs = PS.chosen_logs(data, PS.CONFIGS["default"], ("fast", 0.0025))
    assert row["logs"] == {int(l): int((logs == l).sum())
                           for l in np.unique(logs)}
    assert row["eff_decode_GBps"] == PS.eff_decode_gbps(len(data), logs,
                                                        16384, rates)


def test_rates_need_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    data = BC.Corpora().get("geo", 4 * 16384)
    cfg = {"block_size": 16384, "k": 256}
    with pytest.raises(ValueError, match="CUDA device"):
        PS.measure_rates(data, cfg, device="cpu", out=lambda line: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.main(["policy_sweep"])
