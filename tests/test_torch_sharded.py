"""The sharded driver on a 4-rank gloo group on the CPU against the
port's virtual driver, for CoCoA, mini-batch SCD and mini-batch SGD
(H = 1) under every transport on both fabrics (``xla`` and ``ring``),
plus an ``ef:int4`` run with ``stale:k=2`` and a dropped worker and an
``ef:topk`` run of each, and local SGD (H = 4) under two of them.

One module-scoped group of 4 processes runs the whole matrix (each rank
with its own block only), then the tests read its results:
  * ``compressed`` and ``spark_faithful`` leave the state bit-identical
    to the virtual driver's (the gathered stack is decoded and summed in
    worker order, as there); ``persistent`` and ``reduce_scatter`` add
    in another order (gloo's, or the ring's), so their per-round primal
    is held at rtol 1e-4, the reference's own driver-matrix bound;
  * the bytes derived from each round's recorded calls equal
    ``comm_bytes_per_round()``, in stale and drop rounds too, and a drop
    round logs the same calls as any other;
  * the payload travels in the codec's wire dtypes.
m = 98 and n = 258 are not multiples of K = 4, so the reduce-scatter
exchanges pad (``padded_len``) and the SGD row blocks end short.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis.traffic import (codec_wire_dtype,
                                          derived_round_traffic,
                                          payload_collectives,
                                          quantized_wire_dtypes)
from repro_torch.comm.collectives import CollectiveLog, recording
from repro_torch.core import (CoCoAConfig, CoCoATrainer, ExchangeConfig,
                              MinibatchSCD, MinibatchSGD, SGDConfig)
from repro_torch.core.baselines import WorkerRows
from repro_torch.core.cocoa import WorkerColumns
from repro_torch.data import make_glm_data
from repro_torch.launch.dist import spawn
from repro_torch.utils import spans

M, N, K, DENSITY, ROUNDS = 98, 258, 4, 0.2, 5
ALGOS = ("cocoa", "minibatch_scd", "minibatch_sgd")
TRANSPORTS = ("persistent", "spark_faithful", "compressed:int8",
              "reduce_scatter")
REGIME = "compressed:ef:int4/stale:k=2/drop:1@2-3"
TOPK = "compressed:ef:topk(r=0.125)"
CELLS = ([(a, t + b) for a in ALGOS for t in TRANSPORTS
          for b in ("", "/ring")]
         + [(a, ex) for a in ALGOS for ex in (REGIME, TOPK)]
         + [("local_sgd", REGIME), ("local_sgd", "spark_faithful/ring")])
EXACT = ("compressed", "spark_faithful")    # bit-identical transports
# cells run again by ranks that are given only their own block
BLOCK_CELLS = [("cocoa", "compressed:int8"), ("minibatch_scd",
                                              "spark_faithful/ring"),
               ("minibatch_sgd", "compressed:int8"),
               ("local_sgd", "spark_faithful/ring")]


def _data():
    A, b, _ = make_glm_data(m=M, n=N, density=DENSITY, zipf_a=1.1, seed=42)
    return A, b


def _trainer(algo, ex, A, b, device):
    if algo in ("minibatch_sgd", "local_sgd"):
        H = 4 if algo == "local_sgd" else 1
        return MinibatchSGD(SGDConfig(batch_frac=0.5, step_size=0.1, K=K,
                                      H=H, exchange=ex), A, b, device=device)
    cls = CoCoATrainer if algo == "cocoa" else MinibatchSCD
    return cls(CoCoAConfig(K=K, H=16, exchange=ex), A, b, device=device)


def _block(algo, A, rank):
    """What a rank given only its own block holds of A."""
    if algo in ("minibatch_sgd", "local_sgd"):
        m_local = -(-M // K)
        return WorkerRows(rank, A[rank * m_local:(rank + 1) * m_local], M)
    part = CoCoATrainer(CoCoAConfig(K=K, H=16), A, np.zeros(M),
                        device="cpu").part
    return WorkerColumns(part, rank, A[:, part.owned[rank]].T, N)


def _rank_matrix(rank, world, device):
    """Every cell on this rank: its History, final state and log; then
    the block cells from the rank's own block only."""
    A, b = _data()
    out = {}
    for algo, ex in BLOCK_CELLS:
        tr = _trainer(algo, ex, _block(algo, A, rank), b, device)
        # a block trainer cannot compute p_star (it has no A): given
        hist = tr.run_sharded(ROUNDS, record_every=1, p_star=0.0)
        out["block", algo, ex] = dict(primal=hist.primal,
                                      alpha=tr.alpha_final,
                                      w=getattr(tr, "w_final", None))
    for algo, ex in CELLS:
        tr = _trainer(algo, ex, A, b, device)
        with recording() as log, spans.recording() as slog:
            hist = tr.run_sharded(ROUNDS, record_every=1)
        out[algo, ex] = dict(primal=hist.primal, rounds=hist.rounds,
                             alpha=tr.alpha_final,
                             w=getattr(tr, "w_final", None), log=list(log),
                             spans=[(s.name, s.parent, s.t)
                                    for s in slog.spans],
                             payload=[n for _, n, _, _ in
                                      slog.counted("payload_bytes")])
    # a run of K - 1 workers on the K-rank group: refused before any call
    for algo, tr in (("cocoa", CoCoATrainer(CoCoAConfig(K=K - 1, H=16), A, b,
                                            device=device)),
                     ("minibatch_sgd", MinibatchSGD(SGDConfig(K=K - 1), A, b,
                                                    device=device))):
        try:
            tr.run_sharded(ROUNDS, p_star=0.0)
            out["refused", algo] = None
        except ValueError as e:
            out["refused", algo] = str(e)
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    init = tmp_path_factory.mktemp("sharded") / "init"
    return spawn(K, _rank_matrix, device="cpu", init_file=str(init),
                 timeout_s=180)


@pytest.fixture(scope="module")
def virtual():
    A, b = _data()
    out = {}
    for algo, ex in CELLS:
        tr = _trainer(algo, ex, A, b, "cpu")
        hist = (tr.run_workers(ROUNDS, record_every=1)
                if isinstance(tr, MinibatchSGD) else tr.run(ROUNDS))
        out[algo, ex] = dict(primal=hist.primal, alpha=tr.alpha_final,
                             w=getattr(tr, "w_final", None), trainer=tr)
    return out


def _ids(cell):
    return f"{cell[0]}-{cell[1]}"


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_every_rank_records_the_same_run(sharded, cell):
    first = sharded[0][cell]
    assert first["rounds"] == list(range(1, ROUNDS + 1))
    for r in range(1, K):
        assert sharded[r][cell]["primal"] == first["primal"]
        assert np.array_equal(sharded[r][cell]["alpha"], first["alpha"])
        if first["w"] is not None:
            assert np.array_equal(sharded[r][cell]["w"], first["w"])


SPAN_PARTS = ["draw", "local_step", "exchange", "apply", "metric",
              "read_back"]


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_every_rank_records_the_same_span_tree(sharded, virtual, cell):
    tree = sharded[0][cell]["spans"]
    assert [r[1:] for r in tree[:1]] == [(None, None)]
    assert [n for n, _, _ in tree] == (
        ["solve"] + ["round", *SPAN_PARTS] * ROUNDS + ["finish"])
    rounds = [i for i, (n, _, _) in enumerate(tree) if n == "round"]
    assert [tree[i][2] for i in rounds] == list(range(1, ROUNDS + 1))
    assert all(tree[i + 1 + j][1:] == (i, tree[i][2])
               for i in rounds for j in range(len(SPAN_PARTS)))
    # one count a round: the rank's own update as the codec encoded it
    tr = virtual[cell]["trainer"]
    length = tr.n if isinstance(tr, MinibatchSGD) else tr.m
    assert sharded[0][cell]["payload"] == \
        [tr.scheme.codec.wire_bytes(length)] * ROUNDS
    for r in range(1, K):
        assert sharded[r][cell]["spans"] == tree
        assert sharded[r][cell]["payload"] == sharded[0][cell]["payload"]


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_sharded_state_matches_the_virtual_driver(sharded, virtual, cell):
    got, want = sharded[0][cell], virtual[cell]
    transport = ExchangeConfig.parse(cell[1]).scheme.transport
    if transport in EXACT:
        assert np.array_equal(got["alpha"], want["alpha"])
        if want["w"] is not None:
            assert np.array_equal(got["w"], want["w"])
        # the metric's all-reduce may add in another order
        np.testing.assert_allclose(got["primal"], want["primal"], rtol=1e-6)
    else:
        np.testing.assert_allclose(got["primal"], want["primal"], rtol=1e-4)


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_derived_bytes_match_the_byte_model(sharded, virtual, cell):
    tr = virtual[cell]["trainer"]
    ex = tr.exchange
    log = CollectiveLog(sharded[0][cell]["log"])
    assert log.rounds() == list(range(1, ROUNDS + 1))
    derived = [derived_round_traffic(log.of_round(t), ex, K)
               for t in log.rounds()]
    assert derived == [tr.comm_bytes_per_round()] * ROUNDS
    # the same calls every round: stale rounds and drop rounds included
    calls = [[(c.op, c.dtype, c.nbytes) for c in log.of_round(t)]
             for t in log.rounds()]
    assert all(c == calls[0] for c in calls)
    assert not any(c.staged for c in log)       # host tensors: no copies
    if not ex.membership.empty:
        # the byte model prices the live workers; the fabric moves K
        live = [ex.membership.live_count(t, K) for t in log.rounds()]
        assert live == [4, 3, 3, 4, 4]
        for t, k_live in zip(log.rounds(), live):
            assert tr.comm_bytes_per_round(t) * K == \
                tr.comm_bytes_per_round() * k_live


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_wire_dtypes_are_the_codecs(sharded, virtual, cell):
    tr = virtual[cell]["trainer"]
    codec = tr.exchange.scheme.codec
    log = CollectiveLog(sharded[0][cell]["log"]).of_round(1)
    payload = {c.dtype for c in payload_collectives(log)}
    want = codec_wire_dtype(codec.name)
    assert quantized_wire_dtypes(log) == (set() if want is None else {want})
    if tr.exchange.scheme.transport == "compressed":
        # the encoded wire tuple, never a dequantized f32 update
        length = tr.n if isinstance(tr, MinibatchSGD) else tr.m
        parts = codec.encode(torch.zeros((1, length)))
        assert payload == {str(p.dtype).removeprefix("torch.")
                           for p in parts}
        assert not any(c.dtype == "float32" and c.nbytes >= 4 * length
                       for c in payload_collectives(log))
    else:
        assert payload == {"float32"}



@pytest.mark.parametrize("cell", BLOCK_CELLS, ids=_ids)
def test_a_rank_given_only_its_block_runs_the_same(sharded, cell):
    """``WorkerColumns`` / ``WorkerRows`` in place of the whole matrix:
    the same run bit for bit."""
    for r in range(K):
        got, want = sharded[r]["block", *cell], sharded[r][cell]
        assert got["primal"] == want["primal"]
        assert np.array_equal(got["alpha"], want["alpha"])
        if want["w"] is not None:
            assert np.array_equal(got["w"], want["w"])


@pytest.mark.parametrize("algo", ["cocoa", "minibatch_sgd"])
def test_a_run_whose_K_is_not_the_group_size_is_refused(sharded, algo):
    for r in range(K):
        assert (f"the process group has {K} ranks and the run K={K - 1} "
                f"workers" in sharded[r]["refused", algo])


@pytest.mark.parametrize("algo", ["cocoa", "minibatch_sgd"])
def test_a_block_trainer_holds_one_worker_only(algo):
    A, b = _data()
    tr = _trainer(algo, "compressed:int8", _block(algo, A, 2), b, "cpu")
    with pytest.raises(RuntimeError, match="run_sharded"):
        tr.A
    with pytest.raises(ValueError, match="not worker 1's"):
        tr.worker_data(1)
    assert all(t.shape[0] == 1 for t in tr.worker_data(2))
