"""The port's spans and counters (``diffusion_extensions_tpu_torch/obs.py``)
on the CPU: host spans, counters, snapshots, the device ring's arithmetic
against a plain Python version, and a train step that gives the same bits
with spans on and off.  The card's cases are in ``test_torch_cuda.py``."""
import itertools

import pytest
import torch

from diffusion_extensions_tpu_torch import obs

STEP_SPANS = ["process.noise", "model.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def clean():
    """Spans off and nothing recorded, before and after each test."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def test_spans_nest_with_parents_and_self_time():
    obs.enable("cpu")
    with obs.span("outer"):
        with obs.span("a"):
            pass
        with obs.span("b"):
            with obs.span("c"):
                pass
    snap = obs.snapshot()
    names = [r[0] for r in snap["host"]]
    parents = [r[1] for r in snap["host"]]
    assert names == ["outer", "a", "b", "c"]
    assert parents == [-1, 0, 0, 2]
    for name, parent, start, end in snap["host"]:
        assert end >= start
        if parent >= 0:
            p = snap["host"][parent]
            assert p[2] <= start and end <= p[3]
    dur = [r[3] - r[2] for r in snap["host"]]
    assert obs.self_ns(snap) == [dur[0] - dur[1] - dur[2], dur[1], dur[2] - dur[3], dur[3]]
    assert obs.host_ns(snap, "c") == [dur[3]]
    assert snap["device"] is None  # no card: host times only


def test_spans_off_record_nothing_and_load_nothing():
    assert not obs.enabled()
    first = obs.span("train.step")
    assert first is obs.span("another") is obs._NOOP
    with first:
        with obs.span("inner"):
            pass
    snap = obs.snapshot()
    assert snap["host"] == [] and snap["device"] is None
    assert obs._launch is None and obs._ring is None  # the stamp library was never loaded


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_counters_count_with_spans_on_or_off(on):
    if on:
        obs.enable("cpu")
    obs.count("x")
    obs.count("x", 4)
    obs.count("y", 0)
    assert obs.counter("x") == 5 and obs.counter("y") == 0 and obs.counter("never") == 0
    assert obs.snapshot()["counters"] == {"x": 5, "y": 0}


def test_snapshot_is_a_copy_and_reset_clears():
    obs.enable("cpu")
    obs.count("n", 2)
    with obs.span("s"):
        inside = obs.snapshot()
        with pytest.raises(RuntimeError):
            obs.reset()  # not inside an open span
    assert inside["host"][0][3] is None  # still open when read
    snap = obs.snapshot()
    obs.count("n")
    assert snap["counters"] == {"n": 2} and snap["host"][0][3] is not None
    assert obs.summary(snap)["host_us"] == {"s": (snap["host"][0][3] - snap["host"][0][2]) / 1e3}
    obs.reset()
    assert obs.snapshot() == {"host": [], "device": None, "counters": {}}


@pytest.mark.parametrize("prefix,metric", [("train", "train.kernels_per_step"),
                                           ("moe", "moe.kernels_per_layer")])
def test_capture_count_counts_only_inside_a_capture(monkeypatch, prefix, metric):
    """Outside a capture the block counts nothing; inside one (faked: the
    graph's node count read 10 before the block and 25 after it, 3 of
    them stamps) it adds the 12 nodes and one capture under the names the
    benchmark's metric reads."""
    from benchmark.harness import files

    with obs.capture_count(prefix):
        obs.count("obs.stamps", 3)
    assert obs.snapshot()["counters"] == {"obs.stamps": 3}
    assert files.metric(metric).read({"steps": 1}) is None
    obs.reset()
    nodes = iter([10, 25])
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(obs, "graph_kernels", lambda stream: next(nodes))
    with obs.capture_count(prefix):
        obs.count("obs.stamps", 3)
    assert obs.counter(f"{prefix}.graph_kernels") == 12 and obs.counter(f"{prefix}.captures") == 1
    assert files.metric(metric).read({"steps": 1}) == 12


def _plain_ring(writes, rows):
    """The rows a sequence of stamps leaves, kept as Python dicts: row r
    holds {slot: time}; a ring of ``rows`` lines keeps the last rows - 1
    finished rows."""
    finished, current = [], {}
    for slots, advance, now in writes:
        for s in slots:
            current[s] = now
        if advance:
            finished.append(current)
            current = {}
    return finished[-(rows - 1):], len(finished)


@pytest.mark.parametrize("rows,steps", [(4, 2), (4, 3), (4, 4), (4, 11), (5, 23)])
def test_ring_rows_slots_and_wrap_match_a_plain_version(rows, steps):
    slots = {"step": 0, "noise": 2, "fwd": 4}
    ring = torch.zeros((rows, 6), dtype=torch.int64)
    row = torch.zeros(1, dtype=torch.int64)
    clock = itertools.count(1)
    writes = []
    for i in range(steps):
        writes += [([0], False, next(clock)), ([2], False, next(clock))]
        if i % 3 != 2:  # some rows stamp no forward
            writes += [([3, 4], False, next(clock))]
            writes += [([5, 1], True, next(clock))]
        else:
            writes += [([3, 1], True, next(clock))]
    writes.append(([0, 2], False, next(clock)))  # a row begun, not finished
    for s, adv, now in writes:
        obs.stamp_ref(ring, row, s, adv, now)
    assert int(row[0]) == steps
    kept, begun = _plain_ring(writes, rows)
    got = obs.decode(ring, int(row[0]), slots)
    assert begun == steps
    assert (got["rows"], got["dropped"], got["first_row"]) == (len(kept), steps - len(kept),
                                                               steps - len(kept))
    for name, s in slots.items():
        assert got["spans"][name]["start"] == [r.get(s, 0) for r in kept]
        assert got["spans"][name]["end"] == [r.get(s + 1, 0) for r in kept]


def test_device_spans_stamp_once_where_an_end_meets_a_start(monkeypatch):
    """The spans' stamps through the kernel's plain version (a CPU ring, a
    counting clock): a step of four children takes 6 stamps, an end and the
    next start share one, and each step writes a row of its own."""
    ring = torch.zeros((obs.ROWS + 1, obs.SLOTS), dtype=torch.int64)
    row = torch.zeros(1, dtype=torch.int64)
    clock = itertools.count(1)
    monkeypatch.setattr(obs, "_ring", ring)
    monkeypatch.setattr(obs, "_row", row)
    monkeypatch.setattr(obs, "_launch", lambda s, adv: obs.stamp_ref(ring, row, s, adv, next(clock)))
    obs.enable("cpu")
    for _ in range(3):
        with obs.span("train.step"):
            for name in STEP_SPANS:
                with obs.span(name):
                    pass
        with obs.span("train.replay", device=False):
            pass
    snap = obs.snapshot()
    assert obs.counter("obs.stamps") == 18
    dev = snap["device"]
    assert dev["rows"] == 3 and dev["dropped"] == 0
    spans = dev["spans"]
    for r in range(3):
        start = {n: v["start"][r] for n, v in spans.items()}
        end = {n: v["end"][r] for n, v in spans.items()}
        assert start["process.noise"] == start["train.step"] + 1
        for a, b in zip(STEP_SPANS, STEP_SPANS[1:]):
            assert start[a] < end[a] == start[b]  # one stamp ends a and starts b
        assert end["train.optimizer"] == end["train.step"]
    assert obs.durations_ms(snap, "train.step") == pytest.approx([5e-6] * 3)
    assert obs.gaps_us(snap) == pytest.approx([1e-3] * 2)  # the next row's start is the next stamp
    assert "train.replay" not in spans and len(obs.host_ns(snap, "train.replay")) == 3
    s = obs.summary(snap)
    assert s["device_ms"]["model.forward"] == pytest.approx(1e-6) and s["rows"] == 3


def test_a_flushed_span_stamps_its_end_before_the_work_after_it(monkeypatch):
    """``flush=True`` (the DeepSeek-V2 trunk's FFN spans): the span's end
    takes a stamp of its own at once, so work after it inside the span
    around it (the next layer's attention) counts to neither FFN span; a
    step of two flushed spans inside a forward takes 7 stamps."""
    ring = torch.zeros((obs.ROWS + 1, obs.SLOTS), dtype=torch.int64)
    row = torch.zeros(1, dtype=torch.int64)
    clock = itertools.count(1)
    monkeypatch.setattr(obs, "_ring", ring)
    monkeypatch.setattr(obs, "_row", row)
    monkeypatch.setattr(obs, "_launch", lambda s, adv: obs.stamp_ref(ring, row, s, adv, next(clock)))
    obs.enable("cpu")
    for _ in range(2):
        with obs.span("train.step"):
            with obs.span("model.forward"):
                for name in ("ffn.dense", "moe.l1"):
                    with obs.span(name, flush=True):
                        pass
    assert obs.counter("obs.stamps") == 14
    spans = obs.snapshot()["device"]["spans"]
    for r in range(2):
        start = {n: v["start"][r] for n, v in spans.items()}
        end = {n: v["end"][r] for n, v in spans.items()}
        assert start["model.forward"] < start["ffn.dense"] < end["ffn.dense"] < start["moe.l1"] < end["moe.l1"]
        assert end["moe.l1"] < end["model.forward"] == end["train.step"]


def test_device_counters_add_on_the_device_and_reset_in_place():
    """``device_count``: integers added into a buffer beside the data (here
    the CPU's), read by ``snapshot()`` with the host counters; a call's
    names keep neighbouring places; ``reset()`` zeros the buffer in place
    (a captured graph holds its address)."""
    names = ("test.rows", "test.rows_max")
    obs.count("test.host", 2)
    for v in ([3, 1], [4, 2]):
        obs.device_count(names, torch.tensor(v))
    c = obs.snapshot()["counters"]
    assert (c["test.rows"], c["test.rows_max"], c["test.host"]) == (7, 3, 2)
    buf = obs._device_counts[torch.device("cpu")]
    obs.reset()
    assert obs._device_counts[torch.device("cpu")] is buf and int(buf.abs().sum()) == 0
    assert "test.rows" not in obs.snapshot()["counters"]
    with pytest.raises(RuntimeError):
        obs.device_count(("test.rows_max", "test.other"), torch.tensor([1, 1]))


def _aircraft_steps(on: bool):
    """Three eager Adam steps of a tiny PlaneNet on fixed clouds."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    obs.reset()
    if on:
        obs.enable("cpu")
    args = aircraft.parse_args(["--so3", "--dim", "32", "--heads", "2", "--layers", "1",
                                "--timesteps", "50"])
    model, process = aircraft.build(args, torch.device("cpu"))
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt)
    state = TrainState(model, opt, torch.Generator().manual_seed(7))
    clouds = torch.randn(3, 4, 16, 3, generator=torch.Generator().manual_seed(1))
    losses = []
    for x in clouds:
        state, m = step(state, x)
        losses.append(m["loss"].clone())
    obs.disable()
    return losses, [p.detach().clone() for p in model.parameters()], obs.snapshot()


def test_spans_change_no_bit_of_a_train_step():
    off_losses, off_params, off = _aircraft_steps(False)
    on_losses, on_params, on = _aircraft_steps(True)
    for a, b in zip(off_losses + off_params, on_losses + on_params):
        assert torch.equal(a, b)
    assert off["host"] == [] and on["counters"]["train.eager_steps"] == 3
    assert off["counters"] == on["counters"] == {"train.eager_steps": 3}
    names = [r[0] for r in on["host"]]
    assert names == ["train.step", *STEP_SPANS] * 3
    steps = [i for i, r in enumerate(on["host"]) if r[0] == "train.step"]
    assert all(on["host"][i + 1 + j][1] == i for i in steps for j in range(4))
