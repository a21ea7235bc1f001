"""The port's signature router (``pydcop_tpu_torch/serve/router.py``) on
the CPU, after the router cases of the JAX package's
``tests/unit/test_fleet.py`` (``TestRouter``), case for case, and held to
the JAX package's ``FleetRouter``:

* warm replicas win, a cold key goes least-loaded and sticks, load
  spills past one bucket of queue, down/stalled/partitioned replicas
  are skipped, ``exclude`` bars the dead replica, and the routing key is
  the leading fields of the runner-cache key;
* ``job_routing_key`` equals the JAX package's on the six
  ``tests/instances/*.yaml`` for every batch algorithm;
* a seeded trace of place, finish, up/down, stall, partition, capacity
  and ``note_warm`` events gives the same placements and ``stats()`` as
  the JAX package's router, event for event.
"""
import os

import numpy as np
import pytest

from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.serve.router import FleetRouter as JaxRouter
from pydcop_tpu.serve.router import job_routing_key as jax_routing_key
from pydcop_tpu_torch.batch.engine import (
    SUPPORTED_ALGOS,
    BatchItem,
    _params_key,
    adapter_for,
)
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.serve import FleetRouter, job_routing_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid", "meeting_scheduling", "secp_small"]
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")


class TestRouter:
    def test_warm_replica_wins_placement(self):
        r = FleetRouter()
        r.add_replica("a")
        r.add_replica("b")
        r.note_warm("b", ("k",))
        name, warm = r.place(("k",))
        assert name == "b" and warm

    def test_cold_key_goes_least_loaded_and_sticks(self):
        r = FleetRouter()
        r.add_replica("a")
        r.add_replica("b")
        r.job_placed("a")  # a carries existing load
        name, warm = r.place(("k",))
        assert name == "b" and not warm
        # the family now sticks to b (co-located bucketing)
        name2, warm2 = r.place(("k",))
        assert name2 == "b" and warm2

    def test_spill_past_one_bucket_of_queue(self):
        r = FleetRouter(spill_load=2)
        r.add_replica("a")
        r.add_replica("b")
        placements = [r.place(("k",))[0] for _ in range(4)]
        # a takes the first two (warm affinity), then spills to b
        assert placements[:2] == ["a", "a"]
        assert "b" in placements[2:]

    def test_down_stalled_partitioned_skipped(self):
        r = FleetRouter()
        for n in ("a", "b", "c", "d"):
            r.add_replica(n)
        r.mark_down("a")
        r.set_stalled("b", True)
        r.set_partitioned("c", True)
        assert r.routable() == ["d"]
        assert r.place(("k",))[0] == "d"
        r.set_stalled("b", False)
        assert set(r.routable()) == {"b", "d"}
        r.mark_down("d")
        r.mark_down("b")
        assert r.place(("k",)) is None

    def test_exclude_bars_the_dead_replica(self):
        r = FleetRouter()
        r.add_replica("a")
        r.add_replica("b")
        r.note_warm("a", ("k",))
        assert r.place(("k",), exclude="a")[0] == "b"

    def test_routing_key_matches_cache_key_prefix(self):
        """The routing key is the leading fields of the runner cache
        key the job's bucket will resolve to — same algo/params-key and
        the spec's family_key, with NO tensor compilation needed."""
        dcop = load_dcop_from_file(TUTO)
        key = job_routing_key(dcop, "mgm", {})
        spec = adapter_for("mgm").build_spec(BatchItem(dcop, "mgm", seed=0))
        assert key == ("mgm", _params_key({})) + spec.dims.family_key

    def test_reduced_capacity_drains_toward_whole_peers(self):
        """A replica at half capacity looks twice as loaded: with one
        open job each, the whole peer takes the next cold key."""
        r = FleetRouter()
        r.add_replica("a")
        r.add_replica("b")
        r.job_placed("a")
        r.job_placed("b")
        r.set_capacity("a", 0.5)
        assert r.place(("k",))[0] == "b"
        assert r.capacity("a") == 0.5
        r.mark_up("a")
        assert r.capacity("a") == 1.0

    def test_prefer_emptiest_ignores_warmth(self):
        r = FleetRouter()
        r.add_replica("a")
        r.add_replica("b")
        r.note_warm("a", ("k",))
        r.job_placed("a")
        assert r.place(("k",))[0] == "a"
        assert r.place(("k",), prefer_emptiest=True) == ("b", False)


@pytest.mark.parametrize("algo", SUPPORTED_ALGOS)
@pytest.mark.parametrize("name", NAMES)
def test_routing_key_equals_the_jax_packages(name, algo):
    path = os.path.join(INSTANCES, name + ".yaml")
    params = {"damping": 0.5} if algo == "maxsum" else {}
    mine = job_routing_key(load_dcop_from_file(path), algo, params)
    theirs = jax_routing_key(jax_load([path]), algo, params)
    assert mine == theirs


def _trace(seed, n_events=400, n_replicas=4, n_keys=5):
    """A seeded trace of router events: (method, args, kwargs)."""
    rng = np.random.default_rng(seed)
    names = [f"replica-{i}" for i in range(n_replicas)]
    keys = [("mgm", (), "constraints_hypergraph", (k % 3 + 1,))
            for k in range(n_keys)]
    out = []
    for _ in range(n_events):
        name = names[int(rng.integers(n_replicas))]
        key = keys[int(rng.integers(n_keys))]
        u = rng.random()
        if u < 0.40:
            kw = {}
            if rng.random() < 0.15:
                kw["exclude"] = names[int(rng.integers(n_replicas))]
            if rng.random() < 0.10:
                kw["prefer_emptiest"] = True
            out.append(("place", (key,), kw))
        elif u < 0.62:
            out.append(("job_finished", (name,), {}))
        elif u < 0.67:
            out.append(("mark_down", (name,), {}))
        elif u < 0.74:
            out.append(("mark_up", (name,), {}))
        elif u < 0.80:
            out.append(("set_stalled", (name, bool(rng.random() < 0.5)),
                        {}))
        elif u < 0.86:
            out.append(("set_partitioned",
                        (name, bool(rng.random() < 0.5)), {}))
        elif u < 0.91:
            out.append(("set_capacity",
                        (name, float(rng.choice([0.25, 0.5, 1.0]))), {}))
        elif u < 0.96:
            out.append(("note_warm", (name, key), {}))
        else:
            out.append(("job_placed", (name,), {}))
    return names, out


@pytest.mark.parametrize("spill", [None, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_trace_places_like_the_jax_router(seed, spill):
    names, events = _trace(seed)
    mine, theirs = FleetRouter(spill_load=spill), JaxRouter(spill_load=spill)
    for n in names:
        mine.add_replica(n)
        theirs.add_replica(n)
    placed = 0
    for i, (method, args, kw) in enumerate(events):
        got = getattr(mine, method)(*args, **kw)
        want = getattr(theirs, method)(*args, **kw)
        assert got == want, (i, method, args, kw)
        placed += method == "place" and got is not None
        assert mine.stats() == theirs.stats(), (i, method)
        assert mine.routable() == theirs.routable()
    assert placed > 50
