"""``examples/quickstart_torch.py`` on the CPU (``--device cpu``): the
byte-level LM trained under ``shard_ctx`` on the test mesh of a one-rank
gloo group, then sampled.

The reference example fails under this JAX version (its mesh), so the twin
is held to the reference's unsharded ``make_train_step``: the twin runs as
a subprocess (it starts a process group) for 30 steps, twice at once, and

* its first loss is within 2e-4 of the reference step's loss on the same
  parameters (the twin's, carried across with ``params_to_numpy``) and the
  same first text batch;
* the loss falls;
* the completion is the same in both runs;
* its model, text and optimizer settings are the reference example's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from repro.data.pipeline import DataConfig, TextLM
from repro.launch.steps import make_train_step
from repro.model import lm as jlm
from repro.optim import OptConfig, init_opt_state
from repro_torch.model import lm
from repro_torch.model.convert import params_to_numpy
from torch_examples import load_example

ROOT = Path(__file__).resolve().parents[1]
STEPS = 30
JOIN_SECONDS = 600

RUNNER = textwrap.dedent("""
    import importlib.util, json, sys
    spec = importlib.util.spec_from_file_location("quickstart_torch", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--steps", sys.argv[2]])
    with open(sys.argv[3], "w") as f:
        json.dump({"losses": out["losses"], "completion": out["completion"],
                   "tokens": out["tokens"].tolist(), "steps": out["steps"]}, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quickstart")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                               if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / "quickstart_torch.py"),
         str(STEPS), str(tmp / f"run{i}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(log[-4000:] for log in logs)
    return [json.loads((tmp / f"run{i}.json").read_text()) for i in range(2)], logs


def test_quickstart_settings_are_the_reference_examples():
    twin, ref = load_example("quickstart_torch"), load_example("quickstart")
    assert twin.TEXT == ref.TEXT
    text = (ROOT / "examples" / "quickstart_torch.py").read_text()
    for line in ('name="bytelm", num_layers=4, d_model=128, num_heads=4, num_kv_heads=2',
                 'head_dim=32, d_ff=512, vocab_size=VOCAB, tie_embeddings=True',
                 "lr=3e-3, warmup_steps=20", "seq_len=128, global_batch=16",
                 'kind="text", text=TEXT', "max_new=48", 'prompt = "the actor machine "'):
        assert line in text, line


def test_quickstart_first_loss_matches_reference_step(runs):
    (run, _), _ = runs
    twin = load_example("quickstart_torch")
    cfg = twin.ModelConfig(
        name="bytelm", num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=twin.VOCAB, tie_embeddings=True,
    )
    from repro.configs.base import ModelConfig as JModelConfig

    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JModelConfig)
                           if f.name != "use_pallas"})
    shapes = jax.eval_shape(lambda: jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                      params_to_numpy(lm.init_model(cfg, 0, device="cpu")), shapes)
    opt = OptConfig(lr=3e-3, warmup_steps=20, total_steps=STEPS)
    batch = TextLM(DataConfig(vocab_size=twin.VOCAB, seq_len=128, global_batch=16,
                              kind="text", text=twin.TEXT)).next_batch()
    _, _, m = jax.jit(make_train_step(jcfg, opt))(
        jp, init_opt_state(jp, opt), {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(run["losses"][0] - float(m["loss"])) < 2e-4, (run["losses"][0], float(m["loss"]))


def test_quickstart_loss_falls(runs):
    (run, _), _ = runs
    assert len(run["losses"]) == STEPS
    assert sum(run["losses"][-5:]) / 5 < sum(run["losses"][:5]) / 5 - 1.0


def test_quickstart_completion_is_deterministic(runs):
    (a, b), logs = runs
    assert a["losses"] == b["losses"]
    assert a["tokens"] == b["tokens"] and a["completion"] == b["completion"]
    assert 1 <= a["steps"] <= 48 and "completion:" in logs[0]
