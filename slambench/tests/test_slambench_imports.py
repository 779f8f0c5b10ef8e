"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import json
import subprocess
import sys

from slambench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "mageslam_tpu"}


def loaded_top_level(code: str) -> set:
    probe = (f"import sys\nsys.path.insert(0, {harness.ROOT!r})\n{code}\n"
             "import json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=harness.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    names = loaded_top_level(
        "from slambench import run, harness, check, trace, roofline\n"
        "from slambench.reference import frontend, lm, matching\n"
        "harness.port_modules()\n"
        "b = harness.benchmark()\n"
        "for m in b['end_to_end'] + b['per_layer']: harness.reader(m['name'])\n"
        "for w in b['workloads']: harness.generator(harness.traffic(w['traffic'])['generator'])\n")
    assert "mageslam_tpu_torch" in names          # the program was loaded
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_top_level("from slambench.reference import frontend, lm, matching")
    assert "torch" in names
    assert not names & (FORBIDDEN | {"mageslam_tpu_torch"})
