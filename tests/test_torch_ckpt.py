"""The port's checkpoints and run control (ROADMAP A12) against the
reference's.

  * the same outer state (bridged bits) gives the same checkpoint keys,
    dtypes, meta and sha256 content hash in both packages, for ``heloco``
    and for ``delayed_nesterov`` with its accumulator; only the manifest's
    ``structure``, the reference's description of a JAX tree, differs;
  * each package restores the other's file bit for bit, the accumulator and
    the int32 step included; a tampered file, a wrong hash and a missing
    key raise;
  * ``latest`` picks the highest step by number, ``AsyncSaver`` writes what
    ``save`` writes and copies the state before it returns;
  * ``request_stop`` ends a run at the commit that asked for it;
  * a run checkpointed at step 6 and resumed to 9 from the reference's
    file, in both packages from the same bits: arrivals exact, evals within
    1e-4 and parameters within 5e-4 of each leaf's largest |value|
    (``check_live``), ``restored_arrivals == 6`` and ``t == 9``; with
    ``commit_batch=4`` and a checkpoint every 3 commits the flush reasons
    ("ckpt" among them) are the reference's. A resumed run is not held to
    the uninterrupted one: ``restore`` drops the rounds in flight, in the
    reference as here;
  * the launcher's ``--ckpt-dir``/``--ckpt-every``/``--resume`` on the CPU.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_engine.engine import make_engine as jax_make_engine
from repro.async_engine.engine import make_eval_fn as jax_make_eval_fn
from repro.scenarios import registry as jregistry
from repro_torch import bridge
from repro_torch.async_engine.engine import make_eval_fn
from repro_torch.checkpoint import ckpt
from repro_torch.core.heloco import OuterState
from repro_torch.launch import train
from repro_torch.scenarios import registry, run
from test_torch_methods import check_live, one_intra_op_thread  # noqa: F401
from test_torch_server import _flat


def _nest(flat):
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}: the reference's tree."""
    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _engines(name, **overrides):
    """The reference's and the port's engine of scenario ``name``, the
    port's from the reference's initial parameters."""
    jeng = jax_make_engine(jregistry.get_scenario(name).overridden(
        **overrides))
    eng = registry.get_scenario(name).overridden(**overrides).build(
        device="cpu", init_params=_flat(jeng.server.state.params))
    return jeng, eng


def _random_state(jeng, seed=0):
    """Random params, momentum and (for a buffered method) accumulator of
    the engine's shapes, as numpy, and a step."""
    rng = np.random.default_rng(seed)
    like = _flat(jeng.server.state.params)
    parts = ["params", "momentum"]
    if jeng.server.state.aux is not None:
        parts.append("aux")
    return {part: {k: rng.standard_normal(v.shape).astype(np.float32)
                   for k, v in like.items()} for part in parts}, 5


def _set_state(jeng, eng, parts, step):
    jeng.server.state = jeng.server.state._replace(
        params=_nest(parts["params"]), momentum=_nest(parts["momentum"]),
        step=jnp.asarray(step, jnp.int32),
        aux=_nest(parts["aux"]) if "aux" in parts else None)
    eng.server.state = OuterState(
        params=bridge.to_torch(parts["params"], "cpu"),
        momentum=bridge.to_torch(parts["momentum"], "cpu"), step=step,
        aux=bridge.to_torch(parts["aux"], "cpu") if "aux" in parts else None)


def _manifest(path):
    with open(path + ".manifest.json") as f:
        return json.load(f)


def _port_state(eng):
    state = eng.server.state
    out = {"params": bridge.to_numpy(state.params),
           "momentum": bridge.to_numpy(state.momentum)}
    if state.aux is not None:
        out["aux"] = bridge.to_numpy(state.aux)
    return out, state.step


def _ref_state(jeng):
    state = jeng.server.state
    out = {"params": _flat(state.params), "momentum": _flat(state.momentum)}
    if state.aux is not None:
        out["aux"] = _flat(state.aux)
    return out, np.asarray(state.step)


def _assert_bits(got, want):
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys(), part
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype, (part, k)
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)


@pytest.mark.parametrize("name", ["paper_hetero_severe", "delayed_nesterov"])
def test_same_state_same_file_and_each_restores_the_other(name, tmp_path):
    jeng, eng = _engines(name)
    parts, step = _random_state(jeng)
    _set_state(jeng, eng, parts, step)
    jpath = jeng.checkpoint(str(tmp_path / "ref"))
    path = eng.checkpoint(str(tmp_path / "port"))
    assert os.path.basename(path) == os.path.basename(jpath) == "step_5.npz"
    want, got = _manifest(jpath), _manifest(path)
    assert got.keys() == want.keys()
    for field in sorted(want):
        if field != "structure":
            assert got[field] == want[field], field
    assert ("aux/" + next(iter(parts["params"]))
            in got["keys"]) == (name == "delayed_nesterov")
    assert got["dtypes"]["step"] == "int32"
    with np.load(path) as data:
        assert data["step"].shape == () and data["step"].dtype == np.int32
    # each package restores the other's file into a fresh engine
    jfresh, fresh = _engines(name)
    jfresh.restore(path)
    fresh.restore(jpath)
    got_ref, ref_step = _ref_state(jfresh)
    got_port, port_step = _port_state(fresh)
    _assert_bits(got_ref, parts)
    _assert_bits(got_port, parts)
    assert int(ref_step) == port_step == fresh.server.t == step
    assert isinstance(port_step, int)


def test_tampered_or_incomplete_checkpoints_raise(tmp_path):
    eng = registry.get_scenario("paper_hetero_severe").build(device="cpu")
    path = eng.checkpoint(str(tmp_path))
    with open(path, "r+b") as f:           # as tests/test_async_engine.py
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(Exception):
        eng.restore(path)
    path = eng.checkpoint(str(tmp_path / "hash"))
    manifest = _manifest(path)
    manifest["hash"] = "0" * 64
    with open(path + ".manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="hash mismatch"):
        eng.restore(path)
    # a heloco checkpoint has no accumulator for a buffered method
    dn = registry.get_scenario("delayed_nesterov").build(device="cpu")
    with pytest.raises(IOError, match="missing keys"):
        dn.restore(eng.checkpoint(str(tmp_path / "noaux")))


def test_latest_picks_the_highest_step(tmp_path):
    assert ckpt.latest(str(tmp_path / "none")) is None
    assert ckpt.latest(str(tmp_path)) is None
    for step in (9, 10, 2):
        (tmp_path / f"step_{step}.npz").write_bytes(b"")
    (tmp_path / "other_99.npz").write_bytes(b"")
    assert ckpt.latest(str(tmp_path)) == str(tmp_path / "step_10.npz")


def test_async_saver_writes_what_save_writes(tmp_path):
    eng = registry.get_scenario("delayed_nesterov").build(device="cpu")
    tree = eng.server_tree()
    before = {k: v.clone() for k, v in tree["params"].items()}
    meta = {"time": 1.5, "tokens": 7, "arrivals": 3}
    saver = ckpt.AsyncSaver()
    saver.submit(str(tmp_path / "a.npz"), tree, meta)
    for v in tree["params"].values():       # the state moves on at once
        v.add_(1.0)
    saver.wait()
    ckpt.save(str(tmp_path / "b.npz"), {**tree, "params": before}, meta)
    assert _manifest(str(tmp_path / "a.npz")) == \
        _manifest(str(tmp_path / "b.npz"))
    restored, got_meta = ckpt.restore(str(tmp_path / "a.npz"), tree)
    assert got_meta == meta
    for k, v in before.items():
        assert torch.equal(restored["params"][k], v)


def test_request_stop_ends_the_run_at_that_commit():
    eng = registry.get_scenario("paper_hetero_severe").build(device="cpu")
    evals = make_eval_fn(eng, batch=2)

    def eval_fn(params, step, time):
        if step == 6:
            eng.request_stop()
        return evals(params, step, time)

    hist = eng.run(eval_every=3, eval_fn=eval_fn)
    assert eng.server.t == 6 and len(hist.arrivals) == 6
    assert [e["step"] for e in hist.evals] == [3, 6]
    assert run.arrival_rows(hist) == \
        run.load_golden("paper_hetero_severe")["arrivals"][:6]
    assert hist.summary()["outer_steps"] == 6


def _run_to(jeng, eng, steps, ckpt_every, ckpt_dir):
    """Both engines run on to ``steps`` commits, checkpointing every
    ``ckpt_every`` into ``ckpt_dir``/ref and /port, with one eval at the
    end; returns their histories and the reasons of their commit-buffer
    flushes."""
    out = []
    for e, eval_fn, side in ((jeng, jax_make_eval_fn, "ref"),
                             (eng, make_eval_fn, "port")):
        reasons = []
        drain = e._drain_flush_log

        def spied(e=e, reasons=reasons, drain=drain):
            reasons.extend(ev["reason"] for ev in e.server.flush_log)
            drain()

        e._drain_flush_log = spied
        e.cfg = dataclasses.replace(e.cfg, outer_steps=steps)
        out.append((e.run(eval_fn=eval_fn(e, batch=8),
                          ckpt_every=ckpt_every,
                          ckpt_dir=str(ckpt_dir / side)), reasons))
    return out


@pytest.mark.parametrize("name,overrides,ckpt_every", [
    ("paper_hetero_severe", {}, 6),
    ("fedbuff", {"commit_batch": 4}, 3)])
def test_resume_from_the_reference_checkpoint(name, overrides, ckpt_every,
                                              tmp_path):
    jeng, eng = _engines(name, **overrides)
    (jhist, jreasons), (hist, reasons) = _run_to(jeng, eng, 6, ckpt_every,
                                                 tmp_path / "run")
    check_live(jeng, jhist, eng, hist)
    assert reasons == jreasons
    assert ("ckpt" in reasons) == bool(overrides), reasons
    ref_file = str(tmp_path / "run" / "ref" / "step_6.npz")
    assert ckpt.latest(str(tmp_path / "run" / "port")).endswith("step_6.npz")
    # both packages resume from the reference's file
    jeng, eng = _engines(name, **overrides)
    jeng.restore(ref_file)
    eng.restore(ref_file)
    assert eng.restored_arrivals == jeng.restored_arrivals == 6
    assert (eng.time, eng.history.tokens) == (jeng.time, jeng.history.tokens)
    (jhist, jreasons), (hist, reasons) = _run_to(
        jeng, eng, 9, ckpt_every, tmp_path / "resumed")
    check_live(jeng, jhist, eng, hist)
    assert eng.server.t == jeng.server.t == 9 and len(hist.arrivals) == 3
    assert (hist.tokens, hist.final_time) == (jhist.tokens, jhist.final_time)
    assert reasons == jreasons


def test_launcher_checkpoints_and_resumes(tmp_path, capsys):
    flags = ["--smoke", "--workers", "4", "--paces", "1,2,6,15", "--inner",
             "2", "--batch", "2", "--seq", "16", "--device", "cpu",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    hist = train.main(flags + ["--outer", "6"])
    assert len(hist.arrivals) == 6
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{t}.npz{ext}" for t in (3, 6) for ext in ("",
                                                         ".manifest.json")]
    capsys.readouterr()
    hist = train.main(flags + ["--outer", "9", "--resume"])
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'step_6.npz'} (outer step 6)" in out
    assert [a["outer_step"] for a in hist.arrivals] == [7, 8, 9]
    assert ckpt.latest(str(tmp_path)) == str(tmp_path / "step_9.npz")
