"""The port's telemetry layer (ROADMAP A10) against the reference's.

  * ``stats_from_moments`` equals the reference's float for float;
  * every record kind serialises to the same bytes in both packages and
    decodes with the other's ``from_json_line`` and ``StreamDecoder``, with
    nothing skipped; a recorder's JSONL round-trips, the reference's
    ``iter_jsonl`` reads the port's file, and the analyses agree;
  * the packed sweeps' ``with_stats`` moments (their plain versions on the
    CPU) against the reference's ``reference_moments`` for every registered
    method and for an int8 ``Packed`` delta, and the fused (K, 4) moments
    against ``reference_moments_multi``: rtol = atol = 1e-5 (another
    summation order; the reference's own test allows 1e-3 between its two
    paths);
  * the packed server against the per-leaf server with telemetry on, within
    1e-3 as tests/test_telemetry.py holds the reference's two; a sync
    round's stats against the reference's, on either path, within rtol
    1e-5 / atol 1e-6; a dropped arrival's stats are the momentum's alone;
  * telemetry on against off in the port (``paper_hetero_severe``,
    ``hogwild_rampup``, ``int8_dylu``): the same launch counts and final
    parameters bit for bit, and the records of a live reference run from
    the same bits: the same kinds and counts, arrivals equal but for the
    stats, ``cos_align`` and ``corrected_frac`` within 1e-3 absolute and the
    two norms within 1e-3 relative (measured on the CPU: at most 3.9e-7
    absolute and 1.5e-7 relative on ``paper_hetero_severe`` and
    ``hogwild_rampup``, 2.5e-6 and 3.1e-6 on ``int8_dylu``, whose inner
    rounds drift apart a little more: ROADMAP C1);
  * the launcher's ``--telemetry`` stream decodes with the reference's
    ``StreamDecoder`` with nothing skipped.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jmethods
from repro.core.heloco import OuterState as JaxOuterState
from repro.telemetry import analysis as janalysis
from repro.telemetry import recorder as jrecorder
from repro.telemetry import schema as jschema
from repro.telemetry import stats as jstats
from repro_torch import bridge, kernels
from repro_torch.async_engine.server import Synchronizer
from repro_torch.configs.base import HeLoCoConfig, OuterOptConfig
from repro_torch.core import compression, heloco, packing
from repro_torch.launch import train
from repro_torch.telemetry import analysis, recorder, schema, stats
from test_torch_methods import _live, one_intra_op_thread  # noqa: F401
from test_torch_server import _flat, _tree

H = HeLoCoConfig()
TOL = dict(rtol=1e-5, atol=1e-5)
STAT_FIELDS = ("cos_align", "corrected_frac", "delta_norm", "momentum_norm")


def _torch(t):
    return bridge.to_torch(_flat(t), "cpu")


# ---------------------------------------------------------------------------
# stats, schema, recorder, analysis
# ---------------------------------------------------------------------------

def _moment_cases():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(4).astype(np.float32) for _ in range(16)]
    cases += [np.abs(c) for c in cases[:8]]
    cases += [np.array(c, np.float32) for c in (
        [2.0, 4.0, 1.0, 9.0], [0.0, 0.0, 4.0, 0.0], [0.0, 0.0, 0.0, 0.0],
        [3.0, 1.0, 1.0, 0.0], [-5.0, 1.0, 1.0, 2.0], [1e-30, 1e-30, 1e-30,
                                                      1e-30])]
    return cases


def test_stats_from_moments_equals_reference_float_for_float():
    for mom in _moment_cases():
        want = jstats.stats_from_moments(jnp.asarray(mom))
        for got in (stats.stats_from_moments(torch.from_numpy(mom)),
                    stats.stats_from_moments(mom)):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), mom
    assert stats.MOMENT_FIELDS == jstats.MOMENT_FIELDS
    assert stats.N_MOMENTS == jstats.N_MOMENTS
    np.testing.assert_array_equal(
        stats.momentum_only_moments(torch.tensor(4.0)).numpy(),
        np.asarray(jstats.momentum_only_moments(4.0)))


def _records(mod):
    """One record of every kind, built from the same values in ``mod``."""
    return [
        mod.RunMeta(method="heloco", engine="sim", n_workers=4,
                    outer_steps=12, seed=3, non_iid=True, mixture_alpha=0.3,
                    scenario="paper_hetero_severe"),
        mod.ArrivalMetrics(outer_step=5, worker_id=2, staleness=3,
                           rho=0.4472135954999579, sim_time=12.0,
                           wall_time=0.125, lang="de", dropped=False,
                           cos_align=-0.017068106336185374,
                           corrected_frac=0.6066359684373167,
                           delta_norm=1.1730341963665583,
                           momentum_norm=0.25, mixture=(0.5, 0.25, 0.25),
                           tokens_total=320),
        mod.ArrivalMetrics(outer_step=6, worker_id=1, staleness=7, rho=0.5,
                           sim_time=13.0, wall_time=0.25, lang="iid",
                           dropped=True),
        mod.EvalMetrics(outer_step=6, sim_time=13.0, wall_time=0.5,
                        mean_loss=4.8605, per_lang={"de": 4.9, "en": 4.8}),
        mod.FaultMetrics(event="summary", wall_time=1.0,
                         detail={"dedup": 2.0, "retries": 1.0}),
        mod.RuntimeMetrics(outer_step=6, sim_time=13.0, wall_time=0.5,
                           workers_alive=4, workers_total=4, in_flight=3),
        mod.TransportMetrics(wid=1, pid=4242, wall_time=2.0, frames_sent=9,
                             bytes_sent=1 << 20, ser_s=0.01, final=True),
        mod.FlushMetrics(outer_step=8, sim_time=20.0, wall_time=0.75,
                         depth=4, reason="batch-full", fused=4),
    ]


def test_schema_matches_reference_and_lines_are_byte_identical():
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 4
    assert list(schema.KINDS) == list(jschema.KINDS)
    for kind, cls in schema.KINDS.items():
        assert [(f.name, f.default) for f in dataclasses.fields(cls)] == \
            [(f.name, f.default) for f in dataclasses.fields(
                jschema.KINDS[kind])], kind
    for ours, theirs in zip(_records(schema), _records(jschema)):
        line = schema.to_json_line(ours)
        assert line == jschema.to_json_line(theirs)
        assert dataclasses.asdict(jschema.from_json_line(line)) == \
            dataclasses.asdict(theirs)
        assert schema.from_json_line(line) == ours
    # each package's StreamDecoder reads the other's stream, nothing skipped
    for enc, dec in ((schema, jschema), (jschema, schema)):
        d = dec.StreamDecoder(strict=True)
        got = [d.decode(enc.to_json_line(r)) for r in _records(enc)]
        assert d.drift_report() == [] and d.lines == len(got)
        assert d.meta is not None and d.stream_version == 4
        assert [dataclasses.asdict(r) for r in got] == \
            [dataclasses.asdict(r) for r in _records(dec)]
    with pytest.raises(ValueError, match="drift"):
        schema.from_json_line('{"kind": "flush", "bogus": 1}')


def _fill(rec):
    """Emit one record of each kind through a port recorder."""
    from repro_torch.async_engine.server import ArrivalRecord
    rec.ensure_meta(method="fedbuff", engine="sim", n_workers=2,
                    outer_steps=4, seed=1, scenario="cli")
    rec.record_arrival(ArrivalRecord(1, 0, 0, 0.7, 2.0, "de",
                                     cos_align=0.5, corrected_frac=0.1,
                                     delta_norm=2.0, momentum_norm=1.0),
                       mixture=(0.75, 0.25), tokens_total=64)
    rec.record_arrival(ArrivalRecord(2, 1, 3, 0.5, 3.0, "en", dropped=True),
                       tokens_total=128)
    rec.record_eval({"step": 2, "time": 3.0, "mean": 4.5,
                     "per_lang": {"de": 4.4, "en": 4.6}})
    rec.record_flush(outer_step=2, sim_time=3.0, depth=2, reason="eval",
                     fused=2)
    rec.record_runtime(outer_step=2, sim_time=3.0, workers_alive=2,
                       workers_total=2, in_flight=1)
    rec.record_fault(event="dedup", wid=1, seq=3)
    rec.record_transport(wid=0, pid=7, frames_sent=3)


def test_recorder_round_trips_and_reference_reads_its_files(tmp_path):
    mem = recorder.TelemetryRecorder()
    _fill(mem)
    path = mem.write_jsonl(str(tmp_path / "mem.jsonl"))
    back = recorder.TelemetryRecorder.read_jsonl(path)
    assert back.meta == mem.meta and list(back.records) == list(mem.records)
    assert [schema.kind_of(r) for r in recorder.iter_jsonl(path)] == [
        "meta", "arrival", "arrival", "eval", "flush", "runtime", "fault",
        "transport"]
    theirs = list(jrecorder.iter_jsonl(path))
    assert [dataclasses.asdict(r) for r in theirs] == [
        dataclasses.asdict(r) for r in [mem.meta, *mem.records]]
    jback = jrecorder.TelemetryRecorder.read_jsonl(path)
    assert jback.summary() == mem.summary() == back.summary()
    # a live sink: every line on disk at once, the ring bounded, one writer
    sink = str(tmp_path / "live.jsonl")
    live = recorder.TelemetryRecorder(sink=sink, window=3)
    _fill(live)
    assert len(live.records) == 3
    with open(sink) as f:
        on_disk = [schema.from_json_line(x) for x in f.read().splitlines()]
    assert [_fields(r, ("wall_time",)) for r in on_disk] == \
        [_fields(r, ("wall_time",)) for r in [mem.meta, *mem.records]]
    with pytest.raises(RuntimeError, match="live writer"):
        recorder.TelemetryRecorder(sink=sink)
    live.close()
    assert live.write_jsonl(str(tmp_path / "copy.jsonl"))
    assert (tmp_path / "copy.jsonl").read_text() == open(sink).read()


def test_analysis_equals_reference_on_the_same_records():
    rng = np.random.default_rng(2)
    arrivals, evals = ([], []), ([], [])
    for i in range(40):
        kw = dict(outer_step=i + 1, worker_id=int(rng.integers(4)),
                  staleness=int(rng.integers(5)), rho=float(rng.random()),
                  sim_time=float(i), wall_time=0.0, lang="de",
                  dropped=bool(rng.random() < 0.2),
                  cos_align=(None if i % 9 == 0
                             else float(rng.uniform(-1, 1))),
                  corrected_frac=float(rng.random()),
                  delta_norm=float(rng.random()), tokens_total=64 * (i + 1))
        for out, mod in zip(arrivals, (schema, jschema)):
            out.append(mod.ArrivalMetrics(**kw))
        if i % 10 == 9:
            ev = dict(outer_step=i + 1, sim_time=float(i), wall_time=0.0,
                      mean_loss=float(rng.random()),
                      per_lang={"de": float(rng.random()),
                                "en": float(rng.random())})
            for out, mod in zip(evals, (schema, jschema)):
                out.append(mod.EvalMetrics(**ev))
    ours, theirs = (arrivals[0], evals[0]), (arrivals[1], evals[1])
    assert analysis.summarize(*ours) == janalysis.summarize(*theirs)
    for inc in (False, True):
        assert analysis.staleness_alignment(ours[0], inc) == \
            janalysis.staleness_alignment(theirs[0], inc)
    assert analysis.per_language_curves(ours[1]) == \
        janalysis.per_language_curves(theirs[1])
    assert analysis.language_spread(ours[1]) == \
        janalysis.language_spread(theirs[1])
    assert analysis.summarize([], []) == janalysis.summarize([], [])


# ---------------------------------------------------------------------------
# the packed sweeps' moments against the per-leaf reference
# ---------------------------------------------------------------------------

def _state(seed):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    delta = _tree(rng, 0.05)
    mom = _tree(rng, 0.1)
    return params, delta, mom


def _moments_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", [m.name for m in jmethods.all_methods()])
def test_packed_moments_match_reference_moments(name):
    params, delta, mom = _state(3)
    layout = packing.build_layout(_torch(params))
    pbuf = packing.pack(layout, _torch(params))
    mbuf = packing.pack(layout, _torch(mom))
    abuf = packing.zeros(layout, "cpu") if jmethods.get(name).uses_buffer else None
    out = heloco.apply_arrival_packed(
        pbuf, mbuf, _torch(delta), layout, method=name, outer_lr=0.7, mu=0.9,
        h=H, rho=0.447, tau=3.0, abuf=abuf, phase=1, with_stats=True)
    assert out[-1].shape == (layout.n_rows, 4)
    plain = heloco.apply_arrival_packed(
        pbuf, mbuf, _torch(delta), layout, method=name, outer_lr=0.7, mu=0.9,
        h=H, rho=0.447, tau=3.0, abuf=abuf, phase=1)
    assert len(out) == len(plain) + 1
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    m = jmethods.get(name)
    ctx = jmethods.ArrivalCtx(outer_lr=0.7, mu=0.9, h=H, rho=0.447,
                              tau=jnp.asarray(3.0, jnp.float32), phase=1)
    want = jstats.reference_moments(delta, mom,
                                    m.correct(m, ctx, delta, mom))
    _moments_close(out[-1].sum(0), want)
    # the port's own per-leaf reference agrees too
    from repro_torch.core import methods
    pm = methods.get(name)
    pctx = methods.ArrivalCtx(outer_lr=0.7, mu=0.9, h=H, rho=0.447, tau=3.0,
                              phase=1)
    _moments_close(stats.reference_moments(
        _torch(delta), _torch(mom),
        pm.correct(pm, pctx, _torch(delta), _torch(mom))), want)


def test_packed_moments_of_an_int8_delta():
    """The int8 path hands the server a ``Packed`` decoded buffer; its
    moments match the reference's on the decoded leaves."""
    params, delta, mom = _state(7)
    layout = packing.build_layout(_torch(params))
    decoded, _ef, _n = compression.roundtrip_with_error_feedback(
        _torch(delta), None, "int8", layout=layout)
    assert isinstance(decoded, packing.Packed)
    out = heloco.apply_arrival_packed(
        packing.pack(layout, _torch(params)), packing.pack(layout, _torch(mom)),
        decoded, layout, method="heloco", outer_lr=0.7, mu=0.9, h=H,
        with_stats=True)
    tree = {k: v.numpy() for k, v in packing.unpack(
        layout, decoded.buf, dtype=torch.float32).items()}
    jtree = _nest(tree, delta)
    m = jmethods.get("heloco")
    ctx = jmethods.ArrivalCtx(outer_lr=0.7, mu=0.9, h=H)
    want = jstats.reference_moments(jtree, mom,
                                    m.correct(m, ctx, jtree, mom))
    _moments_close(out[-1].sum(0), want)


def _nest(flat, like):
    """A flat path -> array dict in the nesting of the tree ``like``."""
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    assert _flat(out).keys() == _flat(like).keys()
    return out


@pytest.mark.parametrize(
    "name", [m.name for m in jmethods.all_methods() if m.batchable])
def test_fused_moments_match_reference_moments_multi(name):
    params, _d, mom = _state(11)
    rng = np.random.default_rng(12)
    deltas = [_tree(rng, 0.05) for _ in range(3)]
    rhos, taus, phases = [0.5, 0.4, 0.7], [0.0, 2.0, 5.0], [1, 2, 3]
    layout = packing.build_layout(_torch(params))
    uses_buffer = jmethods.get(name).uses_buffer
    out = heloco.apply_arrivals_packed(
        packing.pack(layout, _torch(params)), packing.pack(layout, _torch(mom)),
        [_torch(d) for d in deltas], layout, method=name, outer_lr=0.7,
        mu=0.9, h=H, rhos=rhos, taus=taus, phases=phases,
        abuf=packing.zeros(layout, "cpu") if uses_buffer else None,
        with_stats=True)
    assert out[-1].shape == (3, layout.n_rows, 4)
    zeros = {k: np.zeros_like(v) for k, v in _flat(mom).items()}
    state = JaxOuterState(params=params, momentum=mom,
                          step=jnp.asarray(0, jnp.int32),
                          aux=_nest(zeros, mom) if uses_buffer else None)
    want = jstats.reference_moments_multi(
        state, deltas, method=name, outer_lr=0.7, mu=0.9, h=H, rhos=rhos,
        taus=taus, phases=phases)
    _moments_close(out[-1].sum(1), want)
    # the port's per-leaf reference of the same flush
    got = stats.reference_moments_multi(
        heloco.OuterState(_torch(params), _torch(mom), 0,
                          bridge.to_torch(zeros, "cpu") if uses_buffer
                          else None),
        [_torch(d) for d in deltas], method=name, outer_lr=0.7, mu=0.9, h=H,
        rhos=rhos, taus=taus, phases=phases)
    _moments_close(got, want)


# ---------------------------------------------------------------------------
# the server: packed against per-leaf, drops, and on/off
# ---------------------------------------------------------------------------

def _feed(srv, n=6, stale_by=3, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        delta = _torch(_tree(rng, 0.05))
        srv.on_arrival(delta, s_i=max(0, srv.t - stale_by), worker_id=0)


@pytest.mark.parametrize("name", ["heloco", "dcasgd", "delayed_nesterov"])
def test_packed_server_stats_match_per_leaf_server(name):
    init = _torch(_tree(np.random.default_rng(5)))
    cfg = OuterOptConfig(method=name)
    a = Synchronizer(dict(init), cfg, 3, packed=True, telemetry=True)
    b = Synchronizer(dict(init), cfg, 3, packed=False, telemetry=True)
    _feed(a)
    _feed(b)
    for ra, rb in zip(a.records, b.records):
        for f in STAT_FIELDS:
            assert getattr(ra, f) is not None, f
            np.testing.assert_allclose(getattr(ra, f), getattr(rb, f),
                                       rtol=1e-3, atol=1e-3, err_msg=f)
    off = Synchronizer(dict(init), cfg, 3)
    _feed(off, n=2)
    assert all(getattr(r, f) is None for r in off.records
               for f in STAT_FIELDS)


@pytest.mark.parametrize("packed", [True, False])
def test_sync_round_stats_match_reference(packed):
    """A barrier round of the synchronous baseline: the stats of the
    averaged pseudo-gradient, against the reference's sync round."""
    from repro.async_engine.server import Synchronizer as JaxSynchronizer
    from repro.configs.base import OuterOptConfig as JaxOuterOptConfig
    rng = np.random.default_rng(9)
    init = _tree(rng)
    ref = JaxSynchronizer(init, JaxOuterOptConfig(method="sync_nesterov"), 3,
                          packed=packed, telemetry=True)
    ours = Synchronizer(_torch(init), OuterOptConfig(method="sync_nesterov"),
                        3, packed=packed, telemetry=True)
    for _ in range(3):
        deltas = [_tree(rng, 0.05) for _ in range(3)]
        want = ref.on_sync_round(deltas, sim_time=2.0)
        got = ours.on_sync_round([_torch(d) for d in deltas], sim_time=2.0)
        for f in STAT_FIELDS:
            assert getattr(got, f) is not None, f
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("packed", [True, False])
def test_dropped_arrival_stats_are_momentum_only(packed):
    init = _torch(_tree(np.random.default_rng(6)))
    srv = Synchronizer(init, OuterOptConfig(method="heloco",
                                            drop_stale_after=1), 2,
                       packed=packed, telemetry=True)
    _feed(srv, n=6, stale_by=4)
    dropped = [r for r in srv.records if r.dropped]
    assert dropped and not srv.records[0].dropped
    for r in dropped:
        assert r.cos_align == 0.0 and r.delta_norm == 0.0
        assert r.corrected_frac == 0.0 and r.momentum_norm > 0.0


def _state_bits(eng):
    st = eng.server.state
    return {f"{part}/{k}": v for part, tree in
            (("p", st.params), ("m", st.momentum), ("a", st.aux or {}))
            for k, v in tree.items()}


def _fields(rec, drop=("wall_time",) + STAT_FIELDS):
    return {k: v for k, v in dataclasses.asdict(rec).items()
            if k not in drop}


@pytest.mark.parametrize("name", ["paper_hetero_severe", "hogwild_rampup",
                                  "int8_dylu"])
def test_telemetry_on_equals_off_and_the_reference_stream(name):
    """Telemetry on against off in the port, from the same bits, and the
    port's stream against a live reference run's (a "runtime" record every
    second commit in both)."""
    from repro.async_engine.engine import make_engine as jax_make_engine
    from repro.scenarios import registry as jregistry
    from repro_torch.async_engine.engine import make_eval_fn
    from repro_torch.scenarios import registry, run
    jrec, rec = jrecorder.TelemetryRecorder(), recorder.TelemetryRecorder()
    kernels.reset_launch_counts()
    _jeng, jhist, eng, hist = _live(name, recorders=(jrec, rec),
                                    telemetry_every=2)
    on_counts = kernels.launch_counts()
    # telemetry off, from the same initial parameters
    init = _flat(jax_make_engine(
        jregistry.get_scenario(name)).server.state.params)
    scn = registry.get_scenario(name).overridden(telemetry_every=2)
    kernels.reset_launch_counts()
    off = scn.build(device="cpu", init_params=init)
    off_hist = off.run(eval_every=scn.eval_cadence,
                       eval_fn=make_eval_fn(off, batch=scn.eval_batch))
    assert kernels.launch_counts() == on_counts
    on_bits, off_bits = _state_bits(eng), _state_bits(off)
    assert on_bits.keys() == off_bits.keys()
    for k, v in on_bits.items():
        assert torch.equal(v, off_bits[k]), k
    assert run.arrival_rows(hist) == run.arrival_rows(off_hist)
    assert hist.evals == off_hist.evals
    assert all(a[f] is None for a in off_hist.arrivals for f in STAT_FIELDS)
    # the stream against the reference's
    assert dataclasses.asdict(rec.meta) == dataclasses.asdict(jrec.meta)
    assert [schema.kind_of(r) for r in rec.records] == \
        [jschema.kind_of(r) for r in jrec.records]
    assert len(rec.arrivals()) == scn.outer_steps and rec.runtime_records()
    for ours, theirs in zip(rec.records, jrec.records):
        if isinstance(ours, schema.EvalMetrics):
            assert abs(ours.mean_loss - theirs.mean_loss) < 1e-4
            assert ours.outer_step == theirs.outer_step
            continue
        assert _fields(ours) == _fields(theirs), (ours, theirs)
        if not isinstance(ours, schema.ArrivalMetrics):
            continue
        for f in STAT_FIELDS:
            got, want = getattr(ours, f), getattr(theirs, f)
            assert got is not None and want is not None, f
            band = 1e-3 * (abs(want) if f.endswith("norm") else 1.0)
            assert abs(got - want) <= band, (f, got, want)
    assert [a["cos_align"] for a in hist.arrivals] == \
        [a.cos_align for a in rec.arrivals()]


def test_launcher_stream_decodes_with_the_reference_decoder(tmp_path,
                                                            capsys):
    path, stats_path = tmp_path / "t.jsonl", tmp_path / "s.json"
    hist = train.main(["--scenario", "paper_hetero_severe", "--telemetry",
                       str(path), "--stats-json", str(stats_path),
                       "--device", "cpu"])
    dec = jschema.StreamDecoder(strict=True)
    recs = [dec.decode(line) for line in path.read_text().splitlines()]
    assert dec.drift_report() == [] and dec.bad_lines == 0
    kinds = [jschema.kind_of(r) for r in recs]
    assert kinds[0] == "meta" and recs[0].scenario == "paper_hetero_severe"
    arrivals = [r for r in recs if isinstance(r, jschema.ArrivalMetrics)]
    assert len(arrivals) == 12 and all(a.cos_align is not None
                                       for a in arrivals)
    # a runtime record after every commit (the cadence defaults to 1 with
    # --telemetry) and one at the end; an eval record per evaluation
    assert kinds.count("runtime") == 13
    assert kinds.count("eval") == len(hist.evals) == 4
    assert json.loads(stats_path.read_text())["arrivals"] == 12
    out = capsys.readouterr().out
    assert "telemetry -> " in out and "12 arrivals mean_cos=" in out
