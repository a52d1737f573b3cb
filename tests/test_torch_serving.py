"""The port's CNN serving engine against ``repro``'s on the same
weights and images, the CLI on the CPU, and the no-card refusal."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CNN_REGISTRY as JAX_CNNS  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import CNN_REGISTRY  # noqa: E402
from repro_torch.models import cnn, params_from_numpy  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engine_class_ids_match_reference_engine():
    cfg, jcfg = CNN_REGISTRY["alexnet-owt"], JAX_CNNS["alexnet-owt"]
    params = numpy_params(jax_cnn.param_defs(jcfg), seed=5)
    rng = np.random.default_rng(6)
    images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(3)]                 # 3 requests, 2 slots
    ours = ServingEngine(cfg, params_from_numpy(params), slots=2,
                         device="cpu")
    ref = JaxEngine(jcfg, _jax_tree(params), slots=2, impl="reference")
    for i, img in enumerate(images):
        ours.submit(Request(uid=i, prompt=img))
        ref.submit(JaxRequest(uid=i, prompt=img))
    got = sorted(ours.run_until_drained(), key=lambda r: r.uid)
    want = sorted(ref.run_until_drained(), key=lambda r: r.uid)
    assert len(got) == 3 and all(r.done for r in got)
    assert ours.n_ticks == 2                      # the second batch padded
    # Compare where the class is well defined: top-2 logit gap > 1e-4.
    x = torch.from_numpy(np.stack(images + [np.zeros_like(images[0])]))
    prog = cnn.compile_program(cfg, batch=2)
    logits = torch.cat([executor.run(prog, ours.params, x[i:i + 2])
                        for i in (0, 2)])[:3]
    top = logits.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > 1e-4
    assert clear.any()
    for r, w, ok in zip(got, want, clear.tolist()):
        if ok:
            assert r.out_tokens == w.out_tokens


def test_engine_serves_the_program_it_is_given():
    """A paper-faithful SNOWFLAKE Program handed to the engine is the one
    it runs (every conv on materialized strips), and its classes equal
    ``repro``'s engine serving the same Program on the same weights."""
    from repro.core import SNOWFLAKE as JAX_SNOWFLAKE
    from repro_torch.core import SNOWFLAKE
    cfg, jcfg = CNN_REGISTRY["alexnet-owt"], JAX_CNNS["alexnet-owt"]
    params = numpy_params(jax_cnn.param_defs(jcfg), seed=11)
    rng = np.random.default_rng(12)
    images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(3)]
    program = cnn.compile_program(cfg, batch=2, hw=SNOWFLAKE,
                                  paper_faithful=True)
    assert program is not cnn.compile_program(cfg, batch=2)
    ours = ServingEngine(cfg, params_from_numpy(params), slots=2,
                         device="cpu", program=program)
    assert ours.program is program
    assert {op.strip_storage for op in program.ops
            if op.kernel == "conv2d"} == {"materialized"}
    ref = JaxEngine(jcfg, _jax_tree(params), slots=2, impl="reference",
                    program=jax_cnn.compile_program(
                        jcfg, batch=2, hw=JAX_SNOWFLAKE,
                        paper_faithful=True))
    for i, img in enumerate(images):
        ours.submit(Request(uid=i, prompt=img))
        ref.submit(JaxRequest(uid=i, prompt=img))
    got = sorted(ours.run_until_drained(), key=lambda r: r.uid)
    want = sorted(ref.run_until_drained(), key=lambda r: r.uid)
    assert ours.n_ticks == 2 and all(r.done for r in got)
    x = torch.from_numpy(np.stack(images + [np.zeros_like(images[0])]))
    logits = torch.cat([executor.run(program, ours.params, x[i:i + 2])
                        for i in (0, 2)])[:3]
    top = logits.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > 1e-4
    assert clear.any()
    for r, w, ok in zip(got, want, clear.tolist()):
        if ok:
            assert r.out_tokens == w.out_tokens == [int(
                logits[r.uid].argmax())]


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "alexnet-owt", "--slots", "2", "--requests", "3", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "program alexnet-owt on tpu_v5e" in proc.stdout
    assert "served 3 images in" in proc.stdout
    assert proc.stdout.count("class ") == 3
    lm = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu"], capture_output=True,
        text=True, env=env, timeout=300)
    assert lm.returncode == 0, lm.stderr
    assert "served 16 requests, 256 tokens in" in lm.stdout
    assert "prefill_recomputes=0" in lm.stdout
    # The vlm has no Program lowering: --program exits 2 with the
    # reference's blocker list; without it the legacy loop serves.
    vlm = ["--arch", "llama-3.2-vision-11b", "--smoke", "--device", "cpu"]
    other = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *vlm,
         "--program"], capture_output=True, text=True, env=env, timeout=300)
    assert other.returncode == 2, other.stderr
    assert ("error: --program requested but llama-3.2-vision-11b-smoke has "
            "no decode-Program lowering") in other.stderr
    assert ("blocked by: family=vlm (not a decoder-only transformer "
            "graph), gated cross-attention (vision bridge), vision-encoder "
            "inputs") in other.stderr
    assert "served" not in other.stdout
    fallback = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *vlm],
        capture_output=True, text=True, env=env, timeout=300)
    assert fallback.returncode == 0, fallback.stderr
    assert "serving through the legacy decode loop" in fallback.stderr
    assert "served 16 requests, 256 tokens in" in fallback.stdout
    audio = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "whisper-base", "--smoke", "--device", "cpu"], capture_output=True,
        text=True, env=env, timeout=300)
    assert audio.returncode == 0, audio.stderr
    assert "served 16 requests, 256 tokens in" in audio.stdout
    assert "prefill_recomputes=0" in audio.stdout


def test_engine_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    params = {"layer_00": {}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(CNN_REGISTRY["alexnet-owt"], params, slots=2)
