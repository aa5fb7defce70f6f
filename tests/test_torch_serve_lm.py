"""The port's token ``Engine`` against the reference's, on the CPU.

Both engines serve the same requests with the same smoke model (the
reference's weights carried across) at fp32.  Every round's logits agree
within 1e-4 of max|logits| while the two runs have fed the same tokens, and
the sampled tokens are expected to be the same; a token that differs must
be a near-tie: the reference's top two logits within that tolerance.
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_common import LM_ARCHS as ARCHS
from torch_port_common import lm_models as models
from torch_port_common import to_np

from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.launch import serve as tserve
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(2)

TOL = 1e-4


def _record(decode, rounds):
    def call(*args):
        logits, caches = decode(*args)
        rounds.append(to_np(logits))
        return logits, caches
    return call


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch, monkeypatch):
    jm, params, tm = models(arch)
    reqs = tserve.make_requests(tm.cfg, 5, 4, seed=3)
    scfg = dict(max_batch=3, max_seq=32)
    jeng = JEngine(jm, params, JServeConfig(**scfg))
    want_rounds, got_rounds = [], []
    jeng._decode = _record(jax.jit(jm.decode_step), want_rounds)
    for r in reqs:
        jeng.submit(JRequest(uid=r.uid, prompt=list(r.prompt),
                             max_new_tokens=r.max_new_tokens))
    want = {r.uid: r.output for r in jeng.run()}

    monkeypatch.setattr(tm, "decode_step", _record(tm.decode_step,
                                                   got_rounds))
    eng = Engine(tm, ServeConfig(**scfg))
    for r in reqs:
        eng.submit(r)
    got = {r.uid: r.output for r in eng.run()}

    assert sorted(got) == sorted(want) == [r.uid for r in reqs]
    assert all(len(out) == 4 for out in got.values())
    v = tm.cfg.vocab
    for g, w in zip(got_rounds, want_rounds):
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= TOL * scale
        flips = g[:, 0, :v].argmax(-1) != w[:, 0, :v].argmax(-1)
        if flips.any():              # only a near-tie may flip a token
            top2 = np.sort(w[flips, 0, :v], axis=-1)[:, -2:]
            assert np.all(top2[:, 1] - top2[:, 0] <= 2 * TOL * scale)
            return                   # the two runs feed other tokens now
    assert got == want


def test_engine_rounds_and_idle_slots(monkeypatch):
    """One decode step per round over all slots; idle slots feed token 0 at
    position 0, as in the reference."""
    _, _, tm = models("phi3-medium-14b")
    seen = []
    decode = tm.decode_step

    def spy(token, caches, pos):
        seen.append((token.clone(), pos.clone()))
        return decode(token, caches, pos)

    monkeypatch.setattr(tm, "decode_step", spy)
    eng = Engine(tm, ServeConfig(max_batch=3, max_seq=16))
    eng.submit(tserve.Request(uid=0, prompt=[5, 6, 7], max_new_tokens=2))
    done = eng.run()
    assert [r.uid for r in done] == [0] and len(done[0].output) == 2
    assert eng.rounds == len(seen) == 4          # 3 prompt + 1 more token
    assert [int(p[0]) for _, p in seen] == [0, 1, 2, 3]
    assert all(int(t[1, 0]) == 0 and int(p[1]) == 0 and int(p[2]) == 0
               for t, p in seen)
    assert [int(t[0, 0]) for t, _ in seen[:3]] == [5, 6, 7]


def test_launch_serve_runs_on_the_cpu(capsys):
    stats = tserve.main(["--arch", "phi3-medium-14b", "--device", "cpu",
                         "--requests", "3", "--new-tokens", "2",
                         "--max-batch", "2"])
    assert stats["requests"] == 3 and stats["tokens"] == 6
    assert "served 3 requests / 6 tokens" in capsys.readouterr().out


def test_launch_serve_svd_runs_on_the_cpu(capsys):
    stats = tserve.main(["--svd", "--device", "cpu", "--requests", "16",
                         "--rate", "200", "--svd-n", "32", "--svd-bw", "4"])
    out = capsys.readouterr().out
    assert stats["served"] == 16 and "served 16/16" in out
    assert "latency p50/p95/p99 = " in out
    assert "'timed_out': 0" in out.split("metrics:")[1]
    assert stats["metrics"]["completed"] == 17      # the warm-up too
    assert stats["health"]["status"] == "ok"


def test_launch_serve_svd_hosts_names_the_later_slice(capsys):
    """``--svd --hosts 2 --device cpu`` serves every request across two
    worker processes (the slice this test once named); without a card and
    without ``--device cpu`` both SVD modes raise, naming the CPU."""
    stats = tserve.main(["--svd", "--hosts", "2", "--device", "cpu",
                         "--requests", "12", "--rate", "100", "--svd-n", "24",
                         "--svd-bw", "4"])
    out = capsys.readouterr().out
    assert stats["served"] == 12 and "served 12/12" in out
    assert "across 2 hosts" in out and sorted(stats["hosts"]) == ["w0", "w1"]
    assert sum(stats["completed_per_host"].values()) == 12
    assert "completed per host:" in out and "merged latency:" in out
    assert stats["fleet"]["latency"]["merged_summary"]["count"] == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--svd", "--requests", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--svd", "--hosts", "2", "--requests", "1"])


def test_launch_serve_padded_vocab_is_never_sampled():
    """granite's vocab pads to a multiple of 256 and its head is the
    embedding; with the pad rows made to win every argmax, greedy sampling
    still picks from ``[:vocab]``."""
    _, _, tm = models("granite-3-2b")
    cfg = tm.cfg
    assert cfg.tie_embeddings and cfg.padded_vocab > cfg.vocab
    embed = tm.state_dict()["embed"]
    saved = embed[cfg.vocab:].clone()
    with torch.no_grad():
        embed[cfg.vocab:] = 100.0
    try:
        stats = tserve.serve(tm, tserve.make_requests(cfg, 2, 3),
                             ServeConfig(max_batch=2, max_seq=16))
    finally:
        with torch.no_grad():
            embed[cfg.vocab:] = saved
    outs = [t for r in stats["done"] for t in r.output]
    assert len(outs) == 6 and all(0 <= t < cfg.vocab for t in outs)
