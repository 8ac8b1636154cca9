"""What the benchmark loads: nothing of JAX or the JAX package, and the
reference nothing of the program (top-level names compared whole; the
port's name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent

PROBE = """
import sys
sys.path.insert(0, {root!r})
import {modules}
tops = {{m.split(".", 1)[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "eetq_tpu", "eetq_tpu_torch"}}))
"""


def _loaded(modules: str) -> str:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), modules=modules)],
                         capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_the_harness_loads_no_jax():
    assert _loaded("servebench.harness, servebench.deploy, servebench.trace") == "['eetq_tpu_torch']"


def test_the_reference_loads_nothing_of_the_program():
    assert _loaded("servebench.reference.check, servebench.reference.model") == "[]"


def test_the_client_loads_neither():
    assert _loaded("servebench.client, servebench.stats, servebench.costs") == "[]"
