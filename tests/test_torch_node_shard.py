"""--node-shard (ROADMAP A8.3) of the port against the JAX package on the CPU.

The port's node axis is a ring of gloo ranks spawned from the package
(``parallel/launch.py``), four a group, meeting at a file store; the jobs
of every test that needs ranks run in one spawn (the ``ranks`` fixture),
so that the file costs one start of four processes.  JAX's side runs on
the 8 virtual CPU devices of ``tests/conftest.py``, on meshes as wide as
the port's ring (JAX ``make_mesh(n_data, n_node)`` over the first four
devices).  Dropout is 0 on both sides; there is no TF32 on the CPU.  The
tests mirror JAX's ``tests/test_parallel.py:76-239, 276-409``,
``tests/test_flags.py:433-501`` and ``tests/test_papers_scale.py:163``:
the layouts bit for bit, the rings and their gradients, sharded inference,
the node-sharded step at S = 4 and on the hybrid 2 x 2 mesh, the trainer's
epochs and the ``--data-shards`` splits.
"""

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_jax_native import ensure_jax_native, jax_native  # noqa: F401 (a fixture)

ensure_jax_native()  # the JAX reference's native runtime, built under a lock

from falcon_ttdforgnns_tpu.graph import rmat_edges
from falcon_ttdforgnns_tpu.graph import sample_block as jax_sample_block
from falcon_ttdforgnns_tpu.graph import synthetic_dataset as jax_synthetic
from falcon_ttdforgnns_tpu.models import SAGE as JaxSAGE
from falcon_ttdforgnns_tpu.parallel import make_mesh as jax_make_mesh
from falcon_ttdforgnns_tpu.parallel import node_sharding as J
from falcon_ttdforgnns_tpu.train import SageTrainer as JaxTrainer
from falcon_ttdforgnns_tpu.train import TrainConfig as JaxConfig
from falcon_ttdforgnns_tpu.train.optim import make_optimizer

from falcon_ttdforgnns_torch.convert import load_jax_variables, params_from_jax
from falcon_ttdforgnns_torch.graph import synthetic_dataset
from falcon_ttdforgnns_torch.parallel import node_sharding as T
from falcon_ttdforgnns_torch.parallel.launch import spawn, train_rank
from falcon_ttdforgnns_torch.parallel.mesh import host_count, resolve_data_shards
from falcon_ttdforgnns_torch.train import SageTrainer, TrainConfig

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

RANKS = 4
LR = 0.01
# the trainer configs of tests/test_flags.py (small_cfg) and of the JAX step tests
SMALL = dict(batch_size=32, fanouts=(2, 3), epochs=1, lr=LR, dropout=0.0, hidden_dim=16,
             num_layers=2, use_tt=True, tt_ranks=(4, 4), weight_dist="normal",
             eval_every=100, log_every=1000, seed=0, steps_per_call=1, skip_eval=True,
             use_sample=False, node_shard=True)


def graph(n, e, seed):
    src, dst = rmat_edges(n, e, seed=seed)
    return src.astype(np.int64), dst.astype(np.int64)


def dense_sum(src, dst, h):
    ref = np.zeros(h.shape, np.float64)
    np.add.at(ref, dst, h[src].astype(np.float64))
    return ref


def same_layout(ours, theirs):
    for f in ("src_r", "dst_r", "nreal", "chunk_offs", "row_of", "node_at"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("max_chunks", "chunk", "block", "num_shards", "num_edges", "num_rows_padded",
              "memory_ratio"):
        assert getattr(ours, f) == getattr(theirs, f), f


# ---------------------------------------------------------------- host layouts

@pytest.mark.parametrize("n,e,seed,S,chunk,balance", [
    (64, 400, 2, 8, 8, True), (64, 400, 2, 8, 8, False), (48, 300, 7, 8, 8, True),
    (3000, 36000, 3, 4, None, True), (200, 1000, 3, 4, 16, True), (160, 800, 4, 4, 16, False),
    (2 ** 14, 400_000, 1, 8, 1024, True)],
    ids=["balanced", "unbalanced", "grad-case", "auto-chunk", "step-case", "hybrid-case",
         "skew"])
def test_ragged_layout_bit_identical(n, e, seed, S, chunk, balance):
    """partition_edges_ragged gives JAX's arrays bit for bit, balanced or
    not and with the auto chunk; on the power-law RMAT at S = 8 the ragged
    layout stays within 1.5x the edges, where the dense one pads past 3x
    (JAX test_skew_memory_bound)."""
    src, dst = graph(n, e, seed)
    ours = T.partition_edges_ragged(src, dst, n, S, chunk=chunk, balance=balance)
    same_layout(ours, J.partition_edges_ragged(src, dst, n, S, chunk=chunk, balance=balance))
    if n == 2 ** 14:
        assert ours.memory_ratio <= 1.5
        assert T.partition_edges_by_block(src, dst, n, S)[0].size / len(src) > 3.0


@pytest.mark.parametrize("n,e,seed,S,pad", [(64, 400, 2, 8, 8), (64, 300, 5, 4, 8),
                                            (2 ** 14, 1_200_000, 1, 8, 1024)],
                         ids=["ring-case", "inference-case", "padding-warning"])
def test_block_layout_bit_identical(jax_native, n, e, seed, S, pad):
    """partition_edges_by_block gives JAX's buckets, weights and block bit
    for bit, and warns as JAX does when the padding is several x E."""
    src, dst = graph(n, e, seed)
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = T.partition_edges_by_block(src, dst, n, S, pad_multiple=pad)
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = J.partition_edges_by_block(src, dst, n, S, pad_multiple=pad)
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[3] == theirs[3]
    assert [str(w.message) for w in ours_w] == [str(w.message) for w in theirs_w]
    assert bool(ours_w) == (n == 2 ** 14)


def test_balanced_assignment_bit_identical_and_balanced():
    """balanced_row_assignment on clamped zipf(1.5) degrees: JAX's rows and
    block, and shard loads within 5% of the mean (JAX's test)."""
    deg = np.minimum(np.random.default_rng(0).zipf(1.5, 4096), 10_000).astype(np.int64)
    row_of, block = T.balanced_row_assignment(deg, 8)
    want_rows, want_block = J.balanced_row_assignment(deg, 8)
    assert block == want_block and np.array_equal(row_of, want_rows)
    loads = np.bincount(row_of // block, weights=deg, minlength=8)
    assert loads.max() / loads.mean() < 1.05


def test_int32_ceiling_raises_as_jax():
    """A shard's padded edge block past 2^31 raises JAX's ValueError before
    anything is allocated (here through a chunk of 2^31)."""
    src, dst = graph(64, 400, 2)
    msgs = []
    for mod in (T, J):
        with pytest.raises(ValueError, match="too large for int32") as e:
            mod.partition_edges_ragged(src, dst, 64, 2, chunk=2 ** 31)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_logical_shards_consume_equals_plain_sum():
    """The ragged layout's local sums at S = 4 logical shards in one
    process (JAX test_ragged_layout_checker_small's graph): each shard
    consumes, at each rotation, the block that rotation delivers, through
    the function the ring calls, in pieces of 1000 edges; the four shards'
    rows are the plain full-graph sum, and so are their transposed sums'."""
    n, S = 3000, 4
    src, dst = graph(n, 12 * n, 3)
    lay = T.partition_edges_ragged(src, dst, n, S)
    h = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    hp = torch.zeros(lay.num_rows_padded, 8)
    hp[torch.as_tensor(lay.row_of)] = torch.as_tensor(h)
    blocks = hp.split(lay.block)
    out, back = torch.zeros_like(hp), torch.zeros_like(hp)
    for d in range(S):
        shard = T.ragged_shard(lay, d, "cpu", edge_chunk=1000)
        for i in range(S):
            T.consume(out[d * lay.block:(d + 1) * lay.block], blocks[(d + i) % S],
                      shard.buckets[i])
            k = (d + i) % S
            T.consume_transposed(back[k * lay.block:(k + 1) * lay.block], blocks[d],
                                 shard.buckets[i])
    np.testing.assert_allclose(out.numpy()[lay.row_of], dense_sum(src, dst, h), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(back.numpy()[lay.row_of], dense_sum(dst, src, h), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n,shards,batch", [(8, -1, 32), (8, 4, 32), (8, 3, 32), (4, -1, 32),
                                            (4, 4, 30), (2, -1, 32), (6, -1, 32), (1, -1, 7)])
def test_data_shards_resolve_as_jax(n, shards, batch, monkeypatch):
    """--data-shards and its defaults over n ranks on one host: JAX's
    _resolve_data_shards, its two ValueErrors included; a torchrun launch
    of 2 hosts of 4 ranks takes one data group a host."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(data_shards=shards, batch_size=batch))
    try:
        want = JaxTrainer._resolve_data_shards(fake, n)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            resolve_data_shards(n, shards, batch)
        assert str(ours.value) == str(e)
    else:
        assert resolve_data_shards(n, shards, batch) == want
    assert host_count() == 1
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert host_count() == 2 and resolve_data_shards(8, -1, 32) == 2


# ------------------------------------------------------- the ranks' jobs, one spawn

def ring_case(n, e, seed, S, chunk=8, d=16):
    src, dst = graph(n, e, seed)
    h = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    lay = T.partition_edges_ragged(src, dst, n, S, chunk=chunk)
    hp = np.zeros((lay.num_rows_padded, d), np.float32)
    hp[lay.row_of] = h
    return src, dst, h, lay, hp


def inference_case(S):
    """JAX TestShardedInference's inputs: the graph, features, degrees and
    weight, and the dense reference of two layers of tanh(mean @ w)."""
    n, d = 64, 8
    src, dst = graph(n, 300, 5)
    h0 = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    in_deg = np.bincount(dst, minlength=n).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(d, d)).astype(np.float32) * 0.3
    h = h0.astype(np.float64)
    for _ in range(2):
        h = np.tanh((dense_sum(src, dst, h) / np.maximum(in_deg, 1.0)[:, None]) @ w)
    return src, dst, h0, in_deg, w, h


def step_case(n, seed, batch):
    """JAX TestNodeShardedTraining's inputs: a SAGE 2 x 16 over ranks 4, 4
    initialised by JAX, the first ``batch`` nodes as seeds."""
    jds = jax_synthetic(num_nodes=n, avg_degree=5, num_classes=4, feat_dim=16, seed=seed)
    model = JaxSAGE(num_nodes=n, in_dim=16, hidden_dim=16, num_classes=4, num_layers=2,
                    use_tt=True, tt_ranks=(4, 4), weight_dist="normal", dropout=0.0)
    b0 = jax_sample_block(jds.graph, np.arange(8), (2, 2), np.random.default_rng(0))
    key = jax.random.PRNGKey(0)
    variables = model.init({"params": key, "dropout": key}, jnp.asarray(b0.seeds),
                           [jnp.asarray(l) for l in b0.layers])
    return jds, model, variables, np.arange(batch, dtype=np.int32)


def jax_steps(jds, model, variables, seeds, S, n_data):
    """JAX's single-device forward_full_graph step and its
    make_node_sharded_full_step on a (n_data, S) mesh: (params, loss) each."""
    src, dst = jds.graph.to_coo()
    in_deg = jds.graph.degrees.astype(np.float32)
    labels = jnp.asarray(jds.labels[seeds].astype(np.int32))
    tx = make_optimizer(lr=LR, plateau=False)

    def ref_step(vs, os_):
        def loss_fn(p):
            logits = model.apply({"params": p}, jnp.asarray(src.astype(np.int32)),
                                 jnp.asarray(dst), jnp.asarray(in_deg), False,
                                 method=JaxSAGE.forward_full_graph)
            return optax.softmax_cross_entropy_with_integer_labels(
                jnp.take(logits, jnp.asarray(seeds), axis=0), labels).mean()
        loss, grads = jax.value_and_grad(loss_fn)(vs["params"])
        ups, _ = tx.update(grads, os_, vs["params"], value=loss)
        return optax.apply_updates(vs["params"], ups), loss

    single = jax.jit(ref_step)(variables, tx.init(variables["params"]))
    lay = J.partition_edges_ragged(src.astype(np.int64), dst.astype(np.int64), jds.num_nodes,
                                   S, chunk=16)
    deg_pad = np.ones((lay.num_rows_padded,), np.float32)
    deg_pad[lay.row_of] = in_deg
    mesh = jax_make_mesh(n_data=n_data, n_node=S, devices=jax.devices()[:n_data * S])
    step = J.make_node_sharded_full_step(model, tx, mesh, 2, lay.max_chunks, lay.chunk,
                                         data_axis="data" if n_data > 1 else None)
    new_vars, _, loss, _ = step(
        variables, tx.init(variables["params"]), *(jnp.asarray(a) for a in (
            lay.src_r, lay.dst_r, lay.nreal, lay.chunk_offs, lay.node_at, deg_pad,
            lay.row_of[seeds].astype(np.int32))), labels, jax.random.PRNGKey(1))
    return single, (new_vars["params"], loss)


def port_cfg(**kw):
    return TrainConfig(**{**SMALL, **kw})


def jax_cfg(**kw):
    return JaxConfig(**{**SMALL, **kw})


@pytest.fixture(scope="module")
def cases():
    """Every input of the ranks' jobs, and what JAX gives for it."""
    c = {"ring": ring_case(64, 400, 2, RANKS), "grad": ring_case(48, 300, 7, RANKS),
         "skew": ring_case(2 ** 14, 400_000, 1, RANKS, chunk=1024, d=4),
         "hybrid": ring_case(64, 400, 2, 2), "inference": inference_case(RANKS)}
    src, dst, h, _, _ = c["ring"]
    src_b, dst_b, w_b, block = T.partition_edges_by_block(src, dst, 64, RANKS, pad_multiple=8)
    hd = np.zeros((block * RANKS, h.shape[1]), np.float32)
    hd[:64] = h
    c["dense"] = (src_b, dst_b, w_b, hd)
    mesh = jax_make_mesh(n_data=1, n_node=RANKS, devices=jax.devices()[:RANKS])
    c["jax_dense"] = np.asarray(J.ring_spmm(mesh, *(jnp.asarray(a) for a in (
        hd, src_b, dst_b, w_b))))[:64]
    lay, hp = c["ring"][3], c["ring"][4]
    c["jax_ragged"] = np.asarray(J.ring_spmm_ragged(
        mesh, *(jnp.asarray(a) for a in (hp, lay.src_r, lay.dst_r, lay.nreal,
                                        lay.chunk_offs)), lay.max_chunks, lay.chunk))[lay.row_of]
    lay, hp = c["grad"][3], c["grad"][4]
    args = tuple(jnp.asarray(a) for a in (lay.src_r, lay.dst_r, lay.nreal, lay.chunk_offs))
    c["jax_grad"] = np.asarray(jax.grad(lambda x: (J.ring_spmm_ragged(
        mesh, x, *args, lay.max_chunks, lay.chunk) ** 2).sum())(jnp.asarray(hp)))[lay.row_of]
    for key, (n, seed, batch, n_data) in {"step": (200, 3, 40, 1),
                                          "hybrid_step": (160, 4, 32, 2)}.items():
        jds, model, variables, seeds = step_case(n, seed, batch)
        host_vars = jax.tree.map(np.asarray, variables)  # JAX's step donates its own
        c[key] = (jds, host_vars, seeds, *jax_steps(jds, model, variables, seeds,
                                                    RANKS // n_data, n_data))
    jds = jax_synthetic(num_nodes=400, avg_degree=6, num_classes=4, feat_dim=16, seed=0)
    c["ds"] = synthetic_dataset(num_nodes=400, avg_degree=6, num_classes=4, feat_dim=16, seed=0)
    for key, kw in {"epoch": {}, "hybrid_epoch": dict(dist=True)}.items():
        jtr = JaxTrainer(jds, jax_cfg(**kw))
        host_vars = jax.tree.map(np.asarray, jtr.variables)
        stats = jtr.train_epoch(0)
        c[key] = (host_vars, jtr, stats)
    return c


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every job on each of the 4 gloo ranks, in one spawn: their results."""
    c = cases
    src, dst, h0, in_deg, w, _ = c["inference"]
    n = 64
    src_b, dst_b, w_b, block = T.partition_edges_by_block(src, dst, n, RANKS, pad_multiple=8)
    h_dense = np.zeros((block * RANKS, 8), np.float32)
    h_dense[:n] = h0
    deg_dense = np.ones(block * RANKS, np.float32)
    deg_dense[:n] = np.maximum(in_deg, 1.0)
    lay = T.partition_edges_ragged(src, dst, n, RANKS, chunk=8)
    h_rag = np.zeros((lay.num_rows_padded, 8), np.float32)
    h_rag[lay.row_of] = h0
    deg_rag = np.ones(lay.num_rows_padded, np.float32)
    deg_rag[lay.row_of] = in_deg
    ring = lambda key, **kw: {"ring": dict(n_data=1, n_node=RANKS, h=c[key][4],  # noqa: E731
                                           layout=c[key][3], **kw)}
    ds = c["ds"]
    one_block = T.partition_edges_ragged(*(a.astype(np.int64) for a in ds.graph.to_coo()),
                                         ds.num_nodes, RANKS)
    first_block = one_block.node_at[:32]  # every seed in node rank 0's rows
    jobs = {
        "dense": {"ring": dict(n_data=1, n_node=RANKS, h=c["dense"][3],
                               buckets=c["dense"][:3], edge_chunk=100)},
        "ragged": ring("ring", edge_chunk=100), "grad": ring("grad"), "skew": ring("skew"),
        "hybrid_ring": {"ring": dict(n_data=2, n_node=2, h=c["hybrid"][4],
                                     layout=c["hybrid"][3])},
        "infer_dense": {"ring": dict(n_data=1, n_node=RANKS, h=h_dense,
                                     buckets=(src_b, dst_b, w_b), deg=deg_dense, weight=w)},
        "infer_ragged": {"ring": dict(n_data=1, n_node=RANKS, h=h_rag, layout=lay,
                                      deg=deg_rag, weight=w)},
    }
    for key, seed in (("step", 3), ("hybrid_step", 4)):
        jds, host_vars, seeds = c[key][:3]
        pds = synthetic_dataset(num_nodes=jds.num_nodes, avg_degree=5, num_classes=4,
                                feat_dim=16, seed=seed)
        jobs[key] = dict(dataset=pds, cfg=port_cfg(batch_size=len(seeds), plateau_patience=0,
                                                   fanouts=(2, 2), dist=key == "hybrid_step"),
                         variables=host_vars, picks=[seeds])
    jobs["epoch"] = dict(dataset=ds, cfg=port_cfg(), variables=c["epoch"][0], epochs=1,
                         infer=True)
    jobs["hybrid_epoch"] = dict(dataset=ds, cfg=port_cfg(dist=True), variables=c["hybrid_epoch"][0],
                                epochs=1, infer=True)
    jobs["one_block"] = dict(dataset=ds, cfg=port_cfg(plateau_patience=0),
                             variables=c["epoch"][0], picks=[first_block])
    jobs["data_shards_4"] = dict(dataset=ds, cfg=port_cfg(dist=True, data_shards=4), epochs=1)
    jobs["data_shards_3"] = dict(dataset=ds, cfg=port_cfg(dist=True, data_shards=3), raises=True)
    jobs["batch_30"] = dict(dataset=ds, cfg=port_cfg(dist=True, data_shards=4, batch_size=30),
                            raises=True)
    jobs["num_chips"] = dict(dataset=ds, cfg=port_cfg(num_chips=2), raises=True)
    jobs["sampled"] = dict(dataset=ds, cfg=port_cfg(use_sample=True, epochs=1), epochs=1,
                           infer=True)
    jobs["sampled_dist_eval_sampled"] = dict(
        dataset=ds, cfg=port_cfg(use_sample=True, dist=True, eval_sampled=True,
                                 eval_sample_max=64), epochs=1, infer=True)
    out = tmp_path_factory.mktemp("ranks")
    spawn(train_rank, RANKS, "cpu", str(out / "store"), list(jobs.values()), str(out))
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return {k: [res[i] for res in results] for i, k in enumerate(jobs)}


def rows_of(results, S=RANKS):
    """The node ranks' blocks, in node order (data index 0)."""
    return [r for r in results if r["at"][0] == 0][:S]


@pytest.mark.parametrize("kind", ["dense", "ragged", "skew"])
def test_ring_matches_jax_and_dense_sum(jax_native, ranks, cases, kind):
    """The ring over 4 gloo ranks (buckets in pieces of 100 edges where
    asked): the dense-bucket ring against JAX's ring_spmm on a 4-device
    node mesh and the plain sum; the ragged ring against JAX's
    ring_spmm_ragged and the plain sum, also on the power-law RMAT of
    2^14 nodes at chunk 1024 (JAX's skew case, 5e-3 relative)."""
    res = ranks[kind]
    out = torch.cat([r["out"] for r in rows_of(res)]).numpy()
    if kind == "dense":
        src, dst, h = cases["ring"][:3]
        got, want = out[:64], cases["jax_dense"]
    else:
        src, dst, h, lay, _ = cases["ring" if kind == "ragged" else kind]
        got = out[lay.row_of]
        want = cases["jax_ragged"] if kind == "ragged" else None
    ref = dense_sum(src, dst, h)
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert (np.abs(got - ref) / (np.abs(ref) + 1e-2)).max() < 5e-3


def test_ring_gradient_is_the_transposed_sum(jax_native, ranks, cases):
    """d/dh of sum(out^2) through the transposed ring (S - 1 rotations the
    other way): JAX's gradient through ring_spmm_ragged and the plain
    2 A^T (A h), at JAX's 1e-3."""
    src, dst, h, lay, _ = cases["grad"]
    g = torch.cat([r["grad"] for r in rows_of(ranks["grad"])]).numpy()[lay.row_of]
    np.testing.assert_allclose(g, cases["jax_grad"], rtol=1e-4, atol=1e-4)
    gref = np.zeros(h.shape, np.float64)
    np.add.at(gref, src, 2.0 * dense_sum(src, dst, h)[dst])
    np.testing.assert_allclose(g, gref, rtol=1e-3, atol=1e-3)


def test_hybrid_mesh_rings_per_data_group(jax_native, ranks, cases):
    """On the 2 x 2 mesh each data group's node ring of 2 gives the whole
    sum; rank r is data index r // 2, node index r % 2."""
    src, dst, h, lay, _ = cases["hybrid"]
    res = ranks["hybrid_ring"]
    assert [r["at"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in range(2):
        out = torch.cat([res[2 * d]["out"], res[2 * d + 1]["out"]]).numpy()[lay.row_of]
        np.testing.assert_allclose(out, dense_sum(src, dst, h), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["infer_dense", "infer_ragged"])
def test_sharded_layerwise_inference_matches_dense(jax_native, ranks, cases, kind):
    """sharded_layerwise_inference over 4 ranks, two layers of tanh(mean @
    w), on the dense buckets and on the ragged layout: the dense reference
    at JAX's 1e-4 (JAX TestShardedInference)."""
    src, dst, *_, want = cases["inference"]
    out = torch.cat([r["layers"] for r in rows_of(ranks[kind])]).numpy()
    if kind == "infer_dense":
        got = out[:64]
    else:
        got = out[T.partition_edges_ragged(src, dst, 64, RANKS, chunk=8).row_of]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key", ["step", "hybrid_step"])
def test_node_sharded_step_matches_jax(jax_native, ranks, cases, key):
    """One node-sharded step from JAX's initialisation on JAX's seeds, at S
    = 4 (200 nodes, 40 seeds) and on the hybrid 2 x 2 mesh (160 nodes, 32
    seeds, 16 a data group): the loss and the parameters against JAX's
    make_node_sharded_full_step and its single-device forward_full_graph
    step at JAX's bounds (loss 1e-4 relative; parameters 5e-4 and 1e-5),
    every rank holding the same parameters."""
    (jsingle, jsingle_loss), (jsharded, jsharded_loss) = cases[key][3:]
    res = ranks[key]
    for r in res[1:]:
        for name in res[0]["state"]:
            assert torch.equal(r["state"][name], res[0]["state"][name]), name
    got = res[0]
    assert got["mesh"] == ((1, 4) if key == "step" else (2, 2)) and not got["data_parallel"]
    for loss, params in ((jsingle_loss, jsingle), (jsharded_loss, jsharded)):
        assert got["losses"][0] == pytest.approx(float(loss), rel=1e-4)
        for name, want in params_from_jax(jax.tree.map(np.asarray, params)).items():
            np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), rtol=5e-4,
                                       atol=1e-5, err_msg=name)


def one_process(ds, cfg, variables):
    tr = SageTrainer(ds, dataclasses.replace(cfg, node_shard=False, dist=False), device="cpu")
    load_jax_variables(tr, variables)
    return tr


def test_step_with_every_seed_in_one_block(jax_native, ranks, cases):
    """A batch whose seeds all lie in node rank 0's rows: the other ranks'
    losses are empty sums, their backward still runs the transposed rings,
    and the step equals the single-device full-neighbour step."""
    c = cases
    ds = c["ds"]
    got = ranks["one_block"][0]
    one = one_process(ds, port_cfg(plateau_patience=0), c["epoch"][0])
    pick = T.partition_edges_ragged(*(a.astype(np.int64) for a in ds.graph.to_coo()),
                                    ds.num_nodes, RANKS).node_at[:32]
    loss, _ = one.full_neighbor_step(torch.as_tensor(pick.astype(np.int64)))
    assert got["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    for name, v in one.model.state_dict().items():
        np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-3 * LR, err_msg=name)


@pytest.mark.parametrize("key", ["epoch", "hybrid_epoch"])
def test_node_shard_trainer_epoch_matches_jax(jax_native, ranks, cases, key):
    """SageTrainer(use_sample=False, node_shard=True[, dist=True]) over 4
    ranks (node mesh 1 x 4; --dist: the hybrid 2 x 2) against JAX's trainer
    on its 8-device mesh (1 x 8; 2 x 4), from the same variables: an epoch
    of 7 steps, the loss at 1e-4 relative, the parameters at the
    full-neighbour tests' margin (1e-4 relative, 3e-3 lr: Adam's floor).
    Then the sharded inference against the single-device infer_full of the
    same state (1e-5) and JAX's (1e-4), and the sharded evaluate's
    accuracies equal to the single-device evaluate's."""
    host_vars, jtr, jstats = cases[key]
    got = ranks[key][0]
    assert got["mesh"] == ((2, 2) if key == "hybrid_epoch" else (1, 4))
    assert got["step"] == jtr.step == 7
    assert got["stats"][0]["loss"] == pytest.approx(jstats["loss"], rel=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jtr.variables["params"]))
    for name, v in want.items():
        np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(), rtol=1e-4,
                                   atol=3 * 1e-3 * LR, err_msg=name)
    one = one_process(cases["ds"], port_cfg(), host_vars)
    one.model.load_state_dict(got["state"])
    np.testing.assert_allclose(got["logits"].numpy(), one.infer_full().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(jtr.infer_full()), rtol=1e-4,
                               atol=1e-4)
    assert got["accs"] == one.evaluate()
    assert all(r["accs"] == got["accs"] for r in ranks[key])


def test_data_shards_and_num_chips_on_ranks(jax_native, ranks):
    """--data-shards 4 over 4 ranks is a 4 x 1 mesh and trains; --data-shards
    3 and a batch of 30 on 4 data groups raise JAX's ValueErrors; --num-chips
    other than the world size raises."""
    got = ranks["data_shards_4"]
    assert got[0]["mesh"] == (4, 1) and np.isfinite(got[0]["stats"][0]["loss"])
    assert "--data-shards 3 does not divide 4 devices" in ranks["data_shards_3"][0]["raised"]
    assert "must divide by the data axis (4)" in ranks["batch_30"][0]["raised"]
    assert "--nproc-per-node 2" in ranks["num_chips"][0]["raised"]


@pytest.mark.parametrize("key", ["sampled", "sampled_dist_eval_sampled"])
def test_sampled_training_under_node_shard(jax_native, ranks, cases, key):
    """Sampled training with --node-shard over 4 ranks: the training step
    is the sampled one (data-parallel under --dist), evaluate and
    infer_full take the ring over a node axis of all 4 ranks (the same
    accuracies as one process's evaluate of the same state) unless
    --eval-sampled, which builds and evaluates by the sampled forward."""
    res = ranks[key]
    got = res[0]
    assert got["mesh"] == (1, 4) and got["data_parallel"] == ("dist" in key)
    assert np.isfinite(got["stats"][0]["loss"])
    one = SageTrainer(cases["ds"], port_cfg(use_sample=True, node_shard=False,
                                            eval_sampled="eval" in key, eval_sample_max=64),
                      device="cpu")
    one.model.load_state_dict(got["state"])
    assert got["accs"] == one.evaluate()
    np.testing.assert_allclose(got["logits"].numpy(), one.infer_full().numpy(), rtol=1e-5,
                               atol=1e-5)
    assert all(r["accs"] == got["accs"] for r in res)


def test_one_rank_group_takes_the_node_sharded_step(tmp_path):
    """A one-rank gloo group given to the trainer takes the node-sharded
    step at any world size (a 1 x 1 mesh, the ring without rotations): an
    epoch equal to the single-device --full-neighbor epoch within f32
    reordering, and the same evaluate(); the mesh of a CUDA trainer given
    the gloo group raises."""
    import torch.distributed as dist
    ds = synthetic_dataset(num_nodes=400, avg_degree=6, num_classes=4, feat_dim=16, seed=0)
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        ns = SageTrainer(ds, port_cfg(), device="cpu", group=dist.group.WORLD)
        one = SageTrainer(ds, port_cfg(), device="cpu")
        assert (ns.node_mesh.n_data, ns.node_mesh.n_node) == (1, 1) and one.node_mesh is None
        stats = [tr.train_epoch(0) for tr in (ns, one)]
        accs = [tr.evaluate() for tr in (ns, one)]
        with pytest.raises(ValueError, match="--node-shard on cuda needs a nccl process "
                                             "group, got gloo"):
            T.node_mesh_for(port_cfg(), "cuda", dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert stats[0]["loss"] == pytest.approx(stats[1]["loss"], rel=1e-6)
    for a, b in zip(ns.model.parameters(), one.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-3 * LR)
    assert accs[0] == accs[1]
