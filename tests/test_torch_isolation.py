"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.simnet import Sim
from repro_torch.launch import serve
from repro_torch.models import decoder
from repro_torch.serving import BatchEngine, GenerationEngine, ShardModule

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
#: the mesh modules the port copies from the JAX package's ``core``
MESH = ("simnet", "peer", "nat", "rpc", "service", "metrics", "dht",
        "blockstore", "bitswap", "pubsub", "rendezvous", "crdt", "traversal",
        "node", "fleet", "cid", "safepickle")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    assert {PORT / "kernels" / "mlstm_scan.py", PORT / "models" / "ssm.py",
            PORT / "kernels" / "moe_gating.py", PORT / "models" / "chunked.py",
            PORT / "optim" / "adamw.py", PORT / "optim" / "clip.py",
            PORT / "optim" / "schedules.py", PORT / "data" / "pipeline.py",
            PORT / "train" / "step.py", PORT / "train" / "trainer.py",
            PORT / "launch" / "train.py",
            PORT / "checkpoint" / "lattica_ckpt.py"} | {
            PORT / "core" / f"{m}.py" for m in MESH} <= set(files)
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert bad == {}


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) > 15, names\n"
        "assert {'repro_torch.kernels.mlstm_scan', 'repro_torch.models.ssm',"
        " 'repro_torch.models.chunked', 'repro_torch.optim.adamw',"
        " 'repro_torch.data.pipeline', 'repro_torch.train.step',"
        " 'repro_torch.train.trainer', 'repro_torch.launch.train',"
        " 'repro_torch.checkpoint.lattica_ckpt'}"
        f" | {{'repro_torch.core.' + m for m in {MESH!r}}}"
        " <= set(names), names\n"
        "assert not bad, bad\n"
        # a payload under the JAX package's wire names decodes into the
        # port's classes without importing the JAX package
        "from repro_torch.checkpoint import lattica_ckpt\n"
        "from repro_torch.core import crdt, dht, peer, safepickle\n"
        "info = dht.PeerInfo(peer.PeerId.from_name('p'), 'p',"
        " (peer.Multiaddr('10.0.0.1', 4001),))\n"
        "orset = crdt.ORSet()\n"
        "orset.add('e', 'p')\n"
        "raw = safepickle.wire_dumps({'publisher': info, 'set': orset})\n"
        "assert b'repro.core.dht' in raw and b'repro_torch' not in raw\n"
        "back = safepickle.restricted_loads(raw,"
        " lattica_ckpt._META_ALLOWED | crdt.ReplicatedStore._WIRE_ALLOWED)\n"
        "assert type(back['publisher']) is dht.PeerInfo\n"
        "assert type(back['set']) is crdt.ORSet\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    cfg = get_config("granite-8b").reduced(n_layers=1, d_model=64, vocab=64)
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def test_entry_points_refuse_a_missing_card(no_cuda):
    cfg, params = _tiny()
    module = ShardModule(cfg, params, (0, 1), is_first=True, is_last=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEngine(module, Sim())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-8b", "--reduced"])
    # asked for explicitly, the CPU works
    BatchEngine(module, Sim(), device="cpu")
    GenerationEngine(cfg, params, device="cpu")


def test_cli_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=granite-8b" in out and "device=cpu" in out


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No card: a non-zero exit and no result line.  Alone in a directory
    (no package beside it): the same."""
    script = (ROOT / "chip_smoke.py").read_text()
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, path in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        res = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
    np.testing.assert_equal(res.stdout.strip(), "")
