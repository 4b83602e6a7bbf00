"""What runs on the card imports neither JAX nor the JAX package, and the
reference imports nothing of the program; a checkout without the program
prints no result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


HARNESS = f"""
import sys
sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench.harness import spec, main
for w in spec.load_benchmark()['workloads']:
    cell = spec.load_cell(w['name'])
    drv = cell.runner()
    [spec.metric_reader(m['name']) for m in cell.per_layer]
    spec.counts('fedgat_' + cell.config['model']['engine'])
import repro_torch.federated.trainer, repro_torch.core.fedgat_vector, repro_torch.graphs.graph
import repro_torch.kernels.cheb_attn, repro_torch.privacy, repro_torch.telemetry
"""


def test_the_harness_and_the_program_load_no_jax_and_no_reference_package():
    mods = loaded_after(HARNESS)
    assert "repro_torch" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded_after(f"""
import sys
sys.path[0:0] = [{str(ROOT)!r}]
import bench.reference.fedgat, bench.reference.judge, bench.reference.frozen
""")
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN + ("repro_torch",)]


def test_the_harness_refuses_a_machine_without_a_card():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "train.arxiv.kernel",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and not out.stdout.strip()


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "train.arxiv.kernel",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
