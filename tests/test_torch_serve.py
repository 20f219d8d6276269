"""Port: the serving driver (``repro_torch.launch.serve``) and its admission.

These tests run the serving entry points on the CPU (``--device cpu``);
on the card ``chip_smoke.py`` drives them. Admission is held to the JAX driver's
``admission_check`` and, where streams queue, to the JAX engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import TPU_V5E_HOST as JAX_TPU_V5E_HOST
from repro.core import ConsolidationEngine as JaxEngine
from repro.core import Workload as JaxWorkload
from repro.core.units import KB, MB
from repro.launch.serve import admission_check as jax_admission_check
from repro_torch.configs import get_config
from repro_torch.convert import kv_cache_from_numpy, lm_params_from_numpy
from repro_torch.core import H100_HOST, TPU_V5E_HOST
from repro_torch.distributed.serve_step import greedy_generate, make_serve_steps
from repro_torch.kernels import flash_attention as kf
from repro_torch.launch import serve
from repro_torch.models import build_model

ARGS = ["--arch", "tinyllama-1.1b", "--smoke", "--requests", "2", "--prompt-len", "16",
        "--gen", "8"]


def test_main_on_cpu_is_deterministic_and_greedy():
    gen = serve.main(ARGS + ["--device", "cpu"])
    assert tuple(gen.shape) == (2, 8) and gen.dtype == torch.int64
    assert bool(((gen >= 0) & (gen < 256)).all())
    torch.testing.assert_close(serve.main(ARGS + ["--device", "cpu"]), gen, rtol=0, atol=0)
    # the same weights and prompts through the library's greedy loop
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model, lm, prompts = serve.prepare(cfg, requests=2, prompt_len=16, device="cpu")
    toks, cache = greedy_generate(model, lm, {"tokens": prompts},
                                  model.init_cache(2, 24, device="cpu"), 8)
    assert torch.equal(toks, gen) and cache["len"] == 23
    assert not kf.LAUNCHES  # the CPU route never launches the kernel


def test_generate_keeps_logits_and_times():
    cfg = get_config("llama3.2-3b", smoke=True)
    model, lm, prompts = serve.prepare(cfg, requests=3, prompt_len=5, seed=2, device="cpu")
    run = serve.generate(model, lm, prompts, 4, keep_logits=True)
    assert tuple(run.tokens.shape) == (3, 4) and len(run.decode_s) == 3 and run.prefill_s > 0
    assert len(run.logits) == 4 and tuple(run.logits[0].shape) == (3, 256)
    for t, logits in enumerate(run.logits):
        assert torch.equal(logits.float().argmax(-1), run.tokens[:, t])


@pytest.mark.parametrize("n", range(1, 7))
def test_admission_matches_jax(n):
    assert serve.admission_check("tinyllama-1.1b", n, host=TPU_V5E_HOST, device="cpu") == \
        jax_admission_check("tinyllama-1.1b", n)


def test_admission_queues_as_the_jax_engine():
    """A host whose HBM budget holds two streams: the rest queue (None)."""
    small = dataclasses.replace(TPU_V5E_HOST, llc_bytes=160 * MB)
    jsmall = dataclasses.replace(JAX_TPU_V5E_HOST, llc_bytes=160 * MB)
    n = 7
    res = JaxEngine([jsmall, jsmall]).run([(0.0, JaxWorkload(fs=64 * MB, rs=256 * KB))] * n)
    want = [None if q else p for p, q in zip(res.placements, res.was_queued)]
    got = serve.admission_check("tinyllama-1.1b", n, host=small, device="cpu")
    assert got == want and None in got and got.count(None) < n


def test_admission_deadlock_admits_nothing_as_jax():
    """A host whose budget no stream fits: the JAX engine deadlocks and the
    port's raises ``Deadlock``, which admission turns into no placements."""
    tiny = dataclasses.replace(TPU_V5E_HOST, llc_bytes=64 * KB)
    jtiny = dataclasses.replace(JAX_TPU_V5E_HOST, llc_bytes=64 * KB)
    stream = [(0.0, JaxWorkload(fs=64 * MB, rs=256 * KB))] * 3
    with pytest.raises(RuntimeError, match="deadlock"):
        JaxEngine([jtiny, jtiny]).run(stream)
    assert serve.admission_check("tinyllama-1.1b", 3, host=tiny, device="cpu") == [None] * 3


def test_admission_lets_scorer_failures_through(monkeypatch):
    """A scorer that fails (as a kernel that does not build or launch
    raises ``RuntimeError``) is not taken for a deadlock."""
    def failing_scorer(cluster, counts, wtypes):
        raise RuntimeError("consolidation_scores: launch failed")

    real = serve.ConsolidationEngine
    monkeypatch.setattr(serve, "ConsolidationEngine",
                        lambda servers, **kw: real(servers, **dict(kw, scorer=failing_scorer)))
    with pytest.raises(RuntimeError, match="launch failed"):
        serve.admission_check("tinyllama-1.1b", 2, device="cpu")


def test_hosts():
    assert dataclasses.asdict(TPU_V5E_HOST) == dataclasses.asdict(JAX_TPU_V5E_HOST)
    assert H100_HOST.llc_bytes == 8 * 80 * 2**30 and H100_HOST.llc_tolerance == 1.0
    assert serve.admission_check("tinyllama-1.1b", 8, device="cpu") == [0, 1] + [0] * 6
    with pytest.raises(NotImplementedError, match="item 7"):
        serve.admission_check("tinyllama-1.1b", 2, device="cpu", metrics=True)


def test_sampling_draws_from_the_generator():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model, lm, prompts = serve.prepare(cfg, requests=2, prompt_len=4, device="cpu")
    _, decode_step = make_serve_steps(model)
    draws = []
    for _ in range(2):
        cache = model.init_cache(2, 6, device="cpu")
        _, cache = model.prefill(lm, {"tokens": prompts}, cache)
        tok, _ = decode_step(lm, cache, prompts[:, -1:], torch.Generator().manual_seed(5), 1.0)
        draws.append(tok)
    assert torch.equal(draws[0], draws[1]) and tuple(draws[0].shape) == (2,)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serving_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    calls = [
        lambda: model.init(),
        lambda: model.init_cache(1, 4),
        lambda: serve.admission_check("tinyllama-1.1b", 2),
        lambda: serve.prepare(cfg, requests=1, prompt_len=4),
        lambda: serve.main(ARGS),
        lambda: lm_params_from_numpy(cfg, {}),
        lambda: kv_cache_from_numpy({"k": np.zeros(1), "v": np.zeros(1), "len": 0}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert model.init(device="cpu").embed.device.type == "cpu"
