"""The port's token ``Engine`` and launcher on the MoE, hymba, RWKV6 and
whisper smoke models, against the reference's, on the CPU (fp32, the
reference's weights carried across).

- Every request admitted in the first round gets the tokens the
  reference's Engine gives it (whisper's requests carry frames).  Later
  requests may differ on purpose: the port zeroes a slot's recurrent state
  when it admits a request, the reference leaves the last occupant's.
- Every request the port answers, in recycled slots too, gets the tokens
  the same request gets alone in a fresh Engine.
- The launcher's request stream, frames included, is the reference
  launcher's for the same seed, and it answers every request.
"""

import numpy as np
import pytest
import torch
from torch_port_common import FAMILY_ARCHS as ARCHS
from torch_port_common import lm_models as models

from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.launch import serve as tserve
from repro_torch.serve import Engine, Request, ServeConfig

torch.set_num_threads(2)

SCFG = dict(max_batch=3, max_seq=24)


def _copy(r) -> Request:
    return Request(uid=r.uid, prompt=list(r.prompt),
                   max_new_tokens=r.max_new_tokens, frames=r.frames)


def _serve(tm, reqs, **scfg) -> dict:
    eng = Engine(tm, ServeConfig(**(scfg or SCFG)))
    for r in reqs:
        eng.submit(_copy(r))
    return {r.uid: r.output for r in eng.run()}


@pytest.mark.parametrize("arch", ARCHS)
def test_first_round_matches_reference_engine(arch):
    """Six requests of 2-8 prompt tokens and 4 new tokens each over three
    slots: the three admitted first answer as in the reference."""
    jm, params, tm = models(arch)
    reqs = tserve.make_requests(tm.cfg, 6, 4, seed=3)
    jeng = JEngine(jm, params, JServeConfig(**SCFG))
    for r in reqs:
        jeng.submit(JRequest(uid=r.uid, prompt=list(r.prompt),
                             max_new_tokens=r.max_new_tokens,
                             frames=r.frames))
    want = {r.uid: r.output for r in jeng.run()}
    got = _serve(tm, reqs)
    assert sorted(got) == sorted(want) == [r.uid for r in reqs]
    assert all(len(out) == 4 for out in got.values())
    for uid in range(SCFG["max_batch"]):
        assert got[uid] == want[uid], uid


@pytest.mark.parametrize("arch", ARCHS)
def test_answers_do_not_depend_on_the_slot_history(arch):
    """Six requests over three slots (three admitted into recycled slots,
    after idle rounds too): each gets the tokens it gets alone in a fresh
    Engine."""
    _, _, tm = models(arch)
    reqs = tserve.make_requests(tm.cfg, 6, 4, seed=5)
    together = _serve(tm, reqs)
    for r in reqs:
        assert together[r.uid] == _serve(tm, [r])[r.uid], r.uid


def test_recycled_slots_start_from_zero_state():
    """After a run, the slots a new request enters hold no recurrent state
    from before: rwkv's token shifts and state and hymba's conv window and
    SSM state of the admitted row are zero before its first step."""
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        _, _, tm = models(arch)
        eng = Engine(tm, ServeConfig(**SCFG))
        for r in tserve.make_requests(tm.cfg, 4, 3, seed=1):
            eng.submit(r)
        eng.run()
        rec = eng.caches if arch == "rwkv6-1.6b" else eng.caches["mamba"]
        assert all(float(v[:, 1].abs().max()) > 0 for v in rec.values())
        eng.submit(Request(uid=9, prompt=[3, 4], max_new_tokens=1))
        eng._admit()
        assert eng.slots[0].req.uid == 9
        assert all(float(v[:, 0].abs().max()) == 0 for v in rec.values())
        assert all(float(v[:, 1].abs().max()) > 0 for v in rec.values())


def test_whisper_frames_change_the_answer():
    """Two requests with one prompt and different frames answer
    differently (the reference's ``test_engine_whisper_cross_attention``);
    the same frames give the same answer."""
    _, _, tm = models("whisper-medium")
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    frames = [rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype("f")
              for _ in range(2)]
    reqs = [Request(uid=u, prompt=[3, 5], max_new_tokens=4, frames=f)
            for u, f in enumerate(frames + frames[:1])]
    out = _serve(tm, reqs, max_batch=2, max_seq=24)
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    assert out[0] != out[1]
    assert out[2] == out[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_matches_the_reference_launcher(arch, monkeypatch,
                                                     capsys):
    """``make_requests`` (seed 0) gives the stream the reference launcher
    submits (prompts, new tokens, whisper's frames), and
    ``launch.serve --arch <arch> --device cpu`` answers all 8 requests."""
    import repro.launch.serve as jserve
    seen = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            pass

        def submit(self, req):
            seen.append(req)

        def run(self):
            return []

    monkeypatch.setattr(jserve, "Engine", Recorder)
    jserve.main(["--arch", arch, "--requests", "8", "--new-tokens", "3"])
    _, _, tm = models(arch)
    mine = tserve.make_requests(tm.cfg, 8, 3, seed=0)
    assert len(seen) == 8
    for a, b in zip(mine, seen):
        assert (a.uid, a.prompt, a.max_new_tokens) == (
            b.uid, b.prompt, b.max_new_tokens)
        if tm.cfg.kind == "encdec":
            np.testing.assert_array_equal(a.frames, b.frames)
        else:
            assert a.frames is None and b.frames is None
    capsys.readouterr()
    stats = tserve.main(["--arch", arch, "--device", "cpu"])
    assert stats["requests"] == 8 and stats["tokens"] == 64
    assert "served 8 requests / 64 tokens" in capsys.readouterr().out
