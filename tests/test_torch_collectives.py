"""The collective fabric's cost model against the reference's
(``repro.comm.collectives``): each backend's ``wire_bytes`` and
``latency_hops``, formula for formula, over every transport and codec
at update lengths 96 and 97, K in {1, 2, 4, 3}, with and without the
live-worker count and the local state; ``get_backend``'s errors; and the
``ring`` segment's parse."""
import itertools

import pytest

from repro.comm import collectives as coll_ref
from repro.comm import get_codec as get_codec_ref
from repro.core import distributed as dist_ref
from repro_torch.comm import collectives as coll
from repro_torch.comm import get_codec
from repro_torch.core import distributed as dist

TRANSPORTS = ("persistent", "spark_faithful", "compressed", "reduce_scatter")
CODECS = ("f32", "int8", "int4", "int2", "topk(r=0.125)", "ef:int4")


@pytest.mark.parametrize("backend", coll.COLLECTIVE_BACKENDS)
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("codec", CODECS)
def test_wire_bytes_match_the_reference(backend, transport, codec):
    ours, ref = coll.get_backend(backend), coll_ref.get_backend(backend)
    for L, K in itertools.product((96, 97), (1, 2, 4, 3)):
        for K_live, state in itertools.product((None, max(K - 1, 1), K),
                                               (0, 5 * K, 64 * K + 3)):
            kw = dict(local_state_len=state, K_live=K_live)
            got = ours.wire_bytes(transport, get_codec(codec), L, K, **kw)
            want = ref.wire_bytes(transport, get_codec_ref(codec), L, K, **kw)
            assert got == want, (L, K, kw)
    # the module-level formula is the fused backend's
    assert coll.wire_bytes(transport, get_codec(codec), 97, 3) == \
        coll_ref.get_backend("xla").wire_bytes(transport,
                                               get_codec_ref(codec), 97, 3)


@pytest.mark.parametrize("backend", coll.COLLECTIVE_BACKENDS)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_latency_hops_match_the_reference(backend, transport):
    for K in (1, 2, 4, 3, 8):
        assert (coll.get_backend(backend).latency_hops(transport, K)
                == coll_ref.get_backend(backend).latency_hops(transport, K))


def test_backend_registry_and_errors():
    assert coll.COLLECTIVE_BACKENDS == coll_ref.COLLECTIVE_BACKENDS
    assert tuple(coll.BACKENDS) == tuple(coll_ref.BACKENDS)
    assert coll.get_backend(None).name == "xla"
    ring = coll.get_backend("ring")
    assert coll.get_backend(ring) is ring
    assert isinstance(ring, coll.CollectiveBackend)
    for bad in ("nccl", "XLA", ""):
        with pytest.raises(ValueError) as ours:
            coll.get_backend(bad)
        with pytest.raises(ValueError) as ref:
            coll_ref.get_backend(bad)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown collective backend"):
        dist.ExchangeConfig(backend="mpi")


@pytest.mark.parametrize("spec", [
    "persistent/ring", "ring/compressed:int8", "compressed:ef:int4/ring",
    "reduce_scatter/ring/stale:k=2",
    "compressed:ef:topk(r=0.125)/stale:k=2/drop:1@5-9/ring",
    "spark_faithful/drop:0@2/ring/straggler:det(slow=4)"])
def test_ring_specs_parse_to_the_reference_spec(spec):
    ours, ref = dist.ExchangeConfig.parse(spec), dist_ref.ExchangeConfig.parse(
        spec)
    assert ours.spec == ref.spec and ours.backend == ref.backend == "ring"
    assert dist.ExchangeConfig.parse(ours.spec) == ours
    assert str(ours) == ours.spec


def test_fabric_needs_a_process_group():
    with pytest.raises(RuntimeError, match="repro_torch.launch.dist"):
        coll.Fabric()
