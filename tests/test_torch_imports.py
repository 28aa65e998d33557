"""Import hygiene of the port: ``bigdl_tpu_torch``, ``chip_smoke.py`` and
``chip_ab.py`` import neither ``jax`` nor any module of ``bigdl_tpu``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "bigdl_tpu")


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    assert len(files) > 20
    # the subpackages and modules of the training loop are scanned too
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"bigdl_tpu_torch/dataset/dataset.py",
            "bigdl_tpu_torch/optim/optimizer.py",
            "bigdl_tpu_torch/utils/module_format.py"} <= names
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []


def test_importing_the_port_loads_neither_jax_nor_bigdl_tpu():
    code = ("import sys\n"
            "import bigdl_tpu_torch, bigdl_tpu_torch.nn, bigdl_tpu_torch.ops.lrn\n"
            "import bigdl_tpu_torch.ops.pool, bigdl_tpu_torch.models.registry\n"
            "import bigdl_tpu_torch.models.cli, bigdl_tpu_torch.serving\n"
            "import bigdl_tpu_torch.utils.convert, bigdl_tpu_torch.optim\n"
            "import bigdl_tpu_torch.parallel, bigdl_tpu_torch.nn.criterion\n"
            "import bigdl_tpu_torch.ops.attention, bigdl_tpu_torch.bench_configs\n"
            "import bigdl_tpu_torch.models.transformer\n"
            "import bigdl_tpu_torch.ops.pooling, bigdl_tpu_torch.ops.norm\n"
            "import bigdl_tpu_torch.models.resnet, bigdl_tpu_torch.dataset\n"
            "import bigdl_tpu_torch.dataset.datasets\n"
            "import bigdl_tpu_torch.optim.optimizer\n"
            "import bigdl_tpu_torch.utils.serializer\n"
            "import bigdl_tpu_torch.utils.ckpt_digest\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
