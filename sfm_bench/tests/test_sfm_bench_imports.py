"""Nothing the harness or the reference loads is JAX or the JAX package, and
the reference loads nothing of the program. Names are compared by their
top-level part, whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys

from helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "orthosfm_tpu"}


def loaded_after(code):
    probe = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    top = loaded_after("import sfm_bench.reference.judge, sfm_bench.reference.refine, "
                       "sfm_bench.inputs.generate, sfm_bench.trace")
    assert not top & (FORBIDDEN | {"orthosfm_torch"})


def test_harness_and_the_program_load_no_jax():
    top = loaded_after(
        "import os, importlib, glob\n"
        "import sfm_bench.harness as h, sfm_bench.port\n"
        "for kind in ('end_to_end', 'layer_metrics'):\n"
        "    for f in glob.glob(os.path.join(h.HERE, kind, '[a-z]*.py')):\n"
        "        h.reader(kind, os.path.basename(f)[:-3])\n"
        "import orthosfm_torch.pipeline.reconstruct, orthosfm_torch.pipeline.incremental\n"
        "import orthosfm_torch.utils.profiling")
    assert "orthosfm_torch" in top
    assert not top & FORBIDDEN


def test_jax_loaded_by_the_judge_stops_the_run():
    """The check runs after the judge, just before the result line: a module
    of JAX that the judge's chain loads leaves no result."""
    from helpers import run_harness

    plant = ("import sys, types\n"
             "import sfm_bench.reference.judge as J\n"
             "_judge = J.judge\n"
             "def judge(*a, **k):\n"
             "    sys.modules['jax'] = types.ModuleType('jax')\n"
             "    return _judge(*a, **k)\n"
             "J.judge = judge\n")
    rc, line, err = run_harness(["--workload", "from_tracks.sweep16", "--seed", "3",
                                 "--seconds", "0.1", "--trace", "0", "--dry-run"], prelude=plant)
    assert rc != 0 and line is None and "jax" in err.splitlines()[-1]
