"""The port's ``parallel/`` (meshes over ``torch.distributed`` ranks, the
data-parallel trainer and sharded serving, the tensor-parallel rules) against
the JAX package's mesh code on the CPU.

The host math (``deal_deepest_first``, ``host_batch_slice``, per-host
``batches``) is compared with JAX's directly.  The distributed paths run in
spawned processes over gloo, each with its own timeout of 180 s: one
two-rank job (``RANKS``) whose outputs several tests read, and the
one-process dry run of tests/test_multihost.py.  Tolerances:

- sharded runners against JAX's mesh runners (a 2-device virtual CPU mesh),
  float32: every decision (routing, tokens, box masks) exactly equal, boxes
  and confidences within 1e-4 (``test_torch_chain``'s TOL; the weights are
  ``test_torch_chain._pair``'s, every decision clear of its threshold by
  more than that);
- a data-parallel step of 2 x 8 rows with unequal mask counts per rank
  against one process's step on the 16 rows: loss within 1e-6 relative,
  gradients within 1e-6 of max|g|, parameters after the Adam step within
  1e-6 of max|p| (all but the attention's key biases, whose exact gradient
  is 0: see the test);
- the tensor-parallel forward against the replicated one: 1e-5.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_chain import CFG, MAX_STEPS, _compare, _pair  # noqa: E402

from explainable_spatial_vqa_tpu.core import config as jax_config  # noqa: E402
from explainable_spatial_vqa_tpu.infer.chain import ExecutorChainRunner as JaxRunner  # noqa: E402
from explainable_spatial_vqa_tpu.infer.chain import deal_deepest_first as jax_deal  # noqa: E402
from explainable_spatial_vqa_tpu.parallel import mesh as jax_mesh  # noqa: E402
from explainable_spatial_vqa_tpu.parallel import multihost as jax_multihost  # noqa: E402
from explainable_spatial_vqa_tpu.train import data as jax_data  # noqa: E402
from explainable_spatial_vqa_tpu_torch.bench_data import synth_executor_steps  # noqa: E402
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, get_preset  # noqa: E402
from explainable_spatial_vqa_tpu_torch.infer.chain import deal_deepest_first  # noqa: E402
from explainable_spatial_vqa_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from explainable_spatial_vqa_tpu_torch.parallel.multihost import host_batch_slice  # noqa: E402
from explainable_spatial_vqa_tpu_torch.train import data as tdata  # noqa: E402
from explainable_spatial_vqa_tpu_torch.train.pipelines import (  # noqa: E402
    executor_pipeline_from_arrays,
)
from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds, each spawned process
N_CHAINS = 19  # odd: the two-rank split pads
# K2's head dim (128) on one head, so the blocks' eval forwards take K2's
# plain version with its fused weights cached on the parameters; no dropout,
# so one process's step and the ranks' draw nothing
DP_CFG = dict(vocab_size=32, d_model=128, num_heads=1, encoder_layers=1, box_decoder_layers=1,
              num_queries=3, num_image_tokens=4, image_feature_dim=8, max_input_boxes=4,
              token_classes=8, box_roi=True, dropout=0.0)
TP_CFG = dict(vocab_size=32, d_model=32, num_heads=4, encoder_layers=2, box_decoder_layers=1,
              num_queries=4, num_image_tokens=16, image_feature_dim=16, max_input_boxes=4,
              token_classes=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(code: str, world: int, *args: str) -> None:
    """Run ``code`` in ``world`` processes (argv: rank, world, port, args),
    each within TIMEOUT; every process is waited for or killed."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), port, *args],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out[-4000:]}"


# ---------------------------------------------------------------------------
# host math against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deal_deepest_first_equal(seed):
    rng = np.random.RandomState(seed)
    num_steps = np.concatenate([rng.randint(1, 3, rng.randint(1, 300)),
                                rng.randint(3, 8, rng.randint(0, 80)),
                                rng.randint(12, 17, rng.randint(0, 40))]).astype(np.int32)
    rng.shuffle(num_steps)
    for d in (1, 2, 3, 4, 8):
        perm = deal_deepest_first(num_steps, d)
        np.testing.assert_array_equal(perm, jax_deal(num_steps, d))
        np.testing.assert_array_equal(np.sort(perm[perm >= 0]), np.arange(len(num_steps)))
        per = len(perm) // d
        totals = [int(num_steps[p[p >= 0]].sum()) for p in perm.reshape(d, per)]
        assert max(totals) - min(totals) <= int(num_steps.max())


def test_host_batch_slice_equal():
    for pc in (1, 2, 4, 8):
        for pi in range(pc):
            assert host_batch_slice(64, pi, pc) == jax_multihost.host_batch_slice(64, pi, pc)
    with pytest.raises(ValueError):
        host_batch_slice(10, 0, 4)
    assert host_batch_slice(12) == slice(0, 12)  # no process group: one process


def test_batches_per_host_equal():
    """Each process's batches equal JAX's per-host batches, and reassemble
    the global batches (same permutation seed)."""
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(50, 3).astype(np.float32), "y": np.arange(50, dtype=np.int32)}
    kw = dict(batch_size=16, shuffle=True, seed=7, epoch=3)
    whole = list(tdata.batches(tdata.Subset(arrays, np.arange(50)), **kw))
    for pc in (1, 2, 4):
        for pi in range(pc):
            got = list(tdata.batches(tdata.Subset(arrays, np.arange(50)), **kw,
                                     process_index=pi, process_count=pc))
            want = list(jax_data.batches(jax_data.Subset(arrays, np.arange(50)), **kw,
                                         process_index=pi, process_count=pc))
            assert len(got) == len(want) == len(whole) == 3
            for g, w, full in zip(got, want, whole):
                for key in arrays:
                    np.testing.assert_array_equal(g[key], w[key])
                    np.testing.assert_array_equal(g[key], full[key][host_batch_slice(16, pi, pc)])
    with pytest.raises(ValueError, match="drop_last"):
        next(tdata.batches(tdata.Subset(arrays, np.arange(50)), 16, drop_last=False,
                           process_index=0, process_count=2))


def test_one_rank_mesh_is_the_identity():
    """Without a process group: a one-rank mesh; padding, row slices and
    gathers as JAX's pad_to_multiple and a one-device mesh give them."""
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.rank() == 0 and mesh.group() is None
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh((2,))
    a = np.arange(26, dtype=np.float32).reshape(13, 2)
    for multiple in (1, 2, 8):
        got, size = tmesh.pad_to_multiple(a, multiple)
        want, wsize = jax_mesh.pad_to_multiple(a, multiple)
        np.testing.assert_array_equal(got, want)
        assert size == wsize == 13
    batch = {"x": a, "p": np.float32(0.5)}
    sharded = tmesh.shard_batch(batch, mesh)
    np.testing.assert_array_equal(sharded["x"], a)
    assert sharded["p"] == batch["p"]
    assert tmesh.batch_sharding(mesh, 13) == slice(0, 13)
    gathered = tmesh.gather_rows({"x": a}, mesh)
    np.testing.assert_array_equal(gathered["x"], a)
    total = torch.tensor(0.0)
    with tmesh.data_parallel(mesh):
        assert float(tmesh.global_normaliser(total)) == 1.0  # max(count, 1)


def test_cli_flags_and_serve_mesh(caplog):
    """The global --multihost flags parse as JAX's do; --data_parallel with
    one process warns and serves unsharded, as JAX does on one device."""
    from explainable_spatial_vqa_tpu.cli import main as jax_cli
    from explainable_spatial_vqa_tpu_torch.cli import main as cli

    argv = ["--multihost", "--coordinator_address", "localhost:1234", "--num_processes", "2",
            "--process_id", "1", "tally", "--questions_h5", "q.h5", "--features_h5", "f.h5",
            "--vocab_json", "v.json", "--split_vocab_json", "s.json", "--data_parallel"]
    args, jargs = cli.build_parser().parse_args(argv), jax_cli.build_parser().parse_args(argv)
    for name in ("multihost", "coordinator_address", "num_processes", "process_id",
                 "data_parallel"):
        assert getattr(args, name) == getattr(jargs, name), name
    chain = cli.build_parser().parse_args(["infer-chain", "--annotated_h5", "a.h5",
                                           "--features_h5", "f.h5", "--vocab_size", "8",
                                           "--data_parallel"])
    assert chain.data_parallel
    assert cli._serve_mesh(args) is None and "serving unsharded" in caplog.text
    assert cli._serve_mesh(cli.build_parser().parse_args(argv[:-1])) is None


def test_data_efficiency_sweep_equal():
    from explainable_spatial_vqa_tpu import evalsuite as jax_evalsuite
    from explainable_spatial_vqa_tpu_torch import evalsuite

    def train(fraction):
        return round(fraction * 3, 6)

    got = evalsuite.data_efficiency_sweep(train)
    assert got == jax_evalsuite.data_efficiency_sweep(train) == {0.01: 0.03, 0.1: 0.3, 1.0: 3.0}
    assert evalsuite.data_efficiency_sweep(train, (0.5,)) == {0.5: 1.5}


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

RANKS = textwrap.dedent(r"""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    from explainable_spatial_vqa_tpu_torch.parallel import multihost
    from explainable_spatial_vqa_tpu_torch.parallel.mesh import make_mesh
    from explainable_spatial_vqa_tpu_torch.parallel.sharding import shard_params_by_rules
    from explainable_spatial_vqa_tpu_torch.core.config import (
        ExecutorConfig, StepSeq2SeqConfig, get_preset)
    from explainable_spatial_vqa_tpu_torch.infer.chain import (
        ExecutorChainRunner, Seq2SeqChainRunner, run_bucketed_seq2seq)
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq
    from explainable_spatial_vqa_tpu_torch.train.datasets import ChainArrays
    from explainable_spatial_vqa_tpu_torch.train.pipelines import executor_pipeline_from_arrays
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    multihost.initialize(f"localhost:{port}", world, rank)
    assert multihost.is_multihost() and multihost.process_index() == rank
    inputs = torch.load(f"{workdir}/inputs.pt", weights_only=False)
    out = {}

    # sharded serving: the JAX-converted executor, every runner on the mesh
    mesh = make_mesh()
    assert mesh.shape == {"data": world} and mesh.rank() == rank
    cfg = ExecutorConfig(**inputs["chain_cfg"])
    model = ProgramExecutor(cfg, device="cpu").eval()
    model.load_state_dict(inputs["chain_state"])
    chains = ChainArrays(*inputs["chains"], [])
    features = inputs["features"]
    per_question = features[chains.image_index]
    runner = ExecutorChainRunner(model, cfg, max_steps=inputs["max_steps"], device="cpu",
                                 mesh=mesh)
    out["run"] = runner.run(per_question, chains)
    out["run_pool"] = runner.run_pool(features, chains, slots=2)
    out["run_sorted"] = runner.run_sorted(torch.from_numpy(per_question), chains, batch=8,
                                          min_tail=2)
    out["run_bucketed"] = runner.run_bucketed(per_question, chains, buckets=(4, 8))

    # the step seq2seq runner on the mesh and alone (same seeded weights)
    s_cfg = StepSeq2SeqConfig(vocab_size=16, d_model=16, num_heads=2, encoder_layers=1,
                              decoder_layers=1, ffn_dim=32, max_src_len=8, max_tgt_len=4,
                              num_image_tokens=4, image_feature_dim=8)
    s_model = init_parameters(StepExecutorSeq2Seq(s_cfg, device="cpu"), 3)
    rng = np.random.RandomState(0)
    n, s = 13, 3
    s_img = rng.rand(n, 4, 8).astype(np.float32)
    deps = np.full((n, s, 2), -1, np.int64)
    deps[:, 1:, 0] = np.arange(s - 1)
    s_chains = ChainArrays(np.arange(n, dtype=np.int32),
                           rng.randint(3, 16, (n, s)).astype(np.int32), deps,
                           rng.randint(1, s + 1, n).astype(np.int32), [])
    out["seq2seq"] = Seq2SeqChainRunner(s_model, s_cfg, max_steps=s, device="cpu",
                                        mesh=mesh).run(s_img, s_chains)
    out["seq2seq_bucketed"] = run_bucketed_seq2seq(
        Seq2SeqChainRunner(s_model, s_cfg, max_steps=s, device="cpu", mesh=mesh), s_img,
        s_chains, buckets=(2,))
    out["seq2seq_alone"] = Seq2SeqChainRunner(s_model, s_cfg, max_steps=s,
                                              device="cpu").run(s_img, s_chains)

    # data parallel: this rank starts from weights of its own seed; the
    # broadcast must reach the eval forward's cached (K2-fused) weights
    dp_cfg = ExecutorConfig(**inputs["dp_cfg"])
    config = get_preset("executor_roi")
    config = config.replace(model=dp_cfg, train=dataclasses.replace(config.train, seed=rank))
    arrays, feats = inputs["dp_data"]
    pipe = executor_pipeline_from_arrays(config, arrays, feats, device="cpu")
    probe = {k: torch.as_tensor(v) for k, v in inputs["probe"].items()}

    def forward():
        with torch.no_grad():
            pipe.model.eval()
            return pipe.model(*(probe[k] for k in ("image", "input_boxes", "input_box_mask",
                                                   "text", "text_mask")))["token_logits"]

    out["own_forward"] = forward()
    trainer = Trainer(pipe.loss_fn, pipe.model, config.optim, config.train,
                      checkpoint_dir=False, device="cpu")
    assert trainer.data_parallel and trainer.mesh.shape == {"data": world}
    out["broadcast_forward"] = forward()
    batch = inputs["dp_batch"]
    rows = slice(rank * len(batch["text"]) // world, (rank + 1) * len(batch["text"]) // world)
    mine = {k: v[rows] for k, v in batch.items()}
    out["box_rows"] = int(mine["is_box_branch"].sum())
    out["target_boxes"] = int(mine["target_box_mask"].sum())
    acc = trainer.train_epoch([mine], seed=0, epoch=0)
    out["totals"] = acc.totals
    out["grads"] = {n: p.grad.clone() for n, p in pipe.model.named_parameters()
                    if p.grad is not None}  # the step's gradients, averaged over the ranks
    out["state"] = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    out["stepped_forward"] = forward()

    # tensor parallel over a (1, world) mesh against the replicated model
    tp_cfg = ExecutorConfig(**inputs["tp_cfg"])
    tp_mesh = make_mesh((1, world), ("data", "model"))
    tp = init_parameters(ProgramExecutor(tp_cfg, device="cpu"), 5).eval()
    tp_args = [torch.as_tensor(a) for a in inputs["tp_args"]]
    with torch.no_grad():
        out["tp_replicated"] = tp(*tp_args)
        shard_params_by_rules(tp, tp_mesh)
        out["tp_sharded"] = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                             for k, v in tp(*tp_args).items()}
    out["tp_placements"] = {
        name: str(p.placements) if hasattr(p, "placements") else None
        for name, p in tp.named_parameters()}
    torch.save(out, f"{workdir}/rank{rank}.pt")
    dist.destroy_process_group()
""")


def _dp_batch():
    """Executor step records, the probe inputs of the eval forwards, and a
    16-row batch ordered so that the two ranks' halves hold different counts
    of box rows and of target boxes."""
    cfg = ExecutorConfig(**DP_CFG)
    arrays, features = synth_executor_steps(200, cfg, seed=1)
    box = np.flatnonzero(arrays["is_box_branch"])
    token = np.flatnonzero(~arrays["is_box_branch"])
    idx = np.concatenate([box[:7], token[:1], box[7:11], token[1:5]])
    batch = {k: v[idx] for k, v in arrays.items()}
    batch["image"] = features[batch["image_index"]]
    probe = {k: batch[k][:4] for k in ("image", "input_boxes", "input_box_mask", "text",
                                       "text_mask")}
    return (arrays, features), batch, probe


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs, the two ranks' outputs and the JAX and single-process
    references."""
    workdir = tmp_path_factory.mktemp("ranks")
    jmodel, jvars, model, features, chains = _pair(CFG)
    keep = np.arange(N_CHAINS)
    chains = type(chains)(chains.image_index[keep], chains.functions[keep],
                          chains.deps[keep], chains.num_steps[keep], [])
    dp_data, dp_batch, probe = _dp_batch()
    rng = np.random.RandomState(0)
    tp_args = (rng.rand(4, 16, 16).astype(np.float32), rng.rand(4, 4, 4).astype(np.float32),
               np.ones((4, 4), bool), rng.randint(0, 32, (4, 3)), np.ones((4, 3), bool))
    torch.save({
        "chain_cfg": CFG, "chain_state": model.state_dict(), "features": features,
        "chains": (chains.image_index, chains.functions, chains.deps, chains.num_steps),
        "max_steps": MAX_STEPS, "dp_cfg": DP_CFG, "dp_data": dp_data, "dp_batch": dp_batch,
        "probe": probe, "tp_cfg": TP_CFG, "tp_args": tp_args,
    }, workdir / "inputs.pt")
    _spawn(RANKS, 2, str(workdir))
    outs = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(jax=(jmodel, jvars, features, chains), dp_data=dp_data, dp_batch=dp_batch,
                probe=probe, outs=outs)


def test_sharded_runners_match_jax_mesh(ranks):
    """run and run_pool over two gloo ranks against JAX's runners on a
    2-device mesh; run_sorted and run_bucketed against JAX's run."""
    jmodel, jvars, features, chains = ranks["jax"]
    mesh = jax_mesh.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    jrunner = JaxRunner(jmodel, jvars, jax_config.ExecutorConfig(**CFG), max_steps=MAX_STEPS,
                        mesh=mesh)
    ref = jrunner.run(np.asarray(features[chains.image_index]), chains)
    ref_pool = jrunner.run_pool(features, chains, slots=2)
    assert ref["box_mask"].any() and ref["token_branch"].any()
    for out in ranks["outs"]:  # every rank gets every output
        _compare(out["run"], ref, "run")
        _compare(out["run_pool"], ref_pool, "run_pool")
        _compare(out["run_sorted"], ref, "run_sorted")
        _compare(out["run_bucketed"], ref, "run_bucketed")


def test_sharded_seq2seq_matches_unsharded(ranks):
    for out in ranks["outs"]:
        for key in ("seq2seq", "seq2seq_bucketed"):
            for name in ("step_outputs", "final_outputs"):
                np.testing.assert_array_equal(out[key][name], out["seq2seq_alone"][name],
                                              err_msg=f"{key} {name}")


def test_data_parallel_step_matches_whole_batch(ranks):
    """Two ranks of 8 rows (unequal box rows and target boxes) against one
    process's step on the 16 rows; and no rank's eval forward reads weights
    cached before the broadcast or the step."""
    outs = ranks["outs"]
    assert outs[0]["box_rows"] != outs[1]["box_rows"]
    assert outs[0]["target_boxes"] != outs[1]["target_boxes"]
    config = get_preset("executor_roi")
    config = config.replace(model=ExecutorConfig(**DP_CFG),
                            train=dataclasses.replace(config.train, seed=0))  # rank 0's
    arrays, features = ranks["dp_data"]
    pipe = executor_pipeline_from_arrays(config, arrays, features, device="cpu")
    probe = {k: torch.as_tensor(v) for k, v in ranks["probe"].items()}

    def forward():
        with torch.no_grad():
            pipe.model.eval()
            return pipe.model(*(probe[k] for k in ("image", "input_boxes", "input_box_mask",
                                                   "text", "text_mask")))["token_logits"]

    initial = forward()
    assert float((outs[1]["own_forward"] - initial).abs().max()) > 1e-3  # other weights
    trainer = Trainer(pipe.loss_fn, pipe.model, config.optim, config.train,
                      checkpoint_dir=False, device="cpu")
    assert trainer.mesh is None
    acc = trainer.train_epoch([ranks["dp_batch"]], seed=0, epoch=0)
    want = acc.totals
    grads = {n: p.grad for n, p in pipe.model.named_parameters() if p.grad is not None}
    stepped = forward()
    state = pipe.model.state_dict()
    g_scale = max(float(g.abs().max()) for g in grads.values())
    p_scale = max(float(v.abs().max()) for v in state.values())
    # The attention's key biases have an exact gradient of 0 (a softmax does
    # not see a shift shared by all of a query's scores): theirs is rounding
    # noise of ~1e-9, which Adam's first step (g / (|g| + 1e-8)) turns into a
    # move of up to the learning rate, in both runs, in another direction.
    noise_only = {k for k in state if k.endswith("attn.k.bias")}
    assert all(float(grads[k].abs().max()) < 1e-6 * g_scale for k in noise_only)
    lr = config.optim.learning_rate
    for out in outs:
        torch.testing.assert_close(out["broadcast_forward"], initial, rtol=0, atol=1e-6)
        got = out["totals"]
        assert set(got) == set(want)
        assert abs(got["loss_sum"] - want["loss_sum"]) <= 1e-6 * abs(want["loss_sum"])
        for key in set(want) - {"loss_sum"}:
            assert got[key] == want[key], key
        assert set(out["grads"]) == set(grads)
        worst = max(float((out["grads"][k] - g).abs().max()) for k, g in grads.items())
        assert worst <= 1e-6 * g_scale, (worst, g_scale)
        worst = max(float((out["state"][k] - v).abs().max()) for k, v in state.items()
                    if k not in noise_only)
        assert worst <= 1e-6 * p_scale, (worst, p_scale)
        for k in noise_only:
            assert float((out["state"][k] - state[k]).abs().max()) <= 2 * lr
        torch.testing.assert_close(out["stepped_forward"], stepped, rtol=0, atol=1e-5)


def test_tensor_parallel_forward_matches_replicated(ranks):
    for out in ranks["outs"]:
        for key, ref in out["tp_replicated"].items():
            torch.testing.assert_close(out["tp_sharded"][key], ref, rtol=0, atol=1e-5,
                                       msg=key)
        placements = out["tp_placements"]
        assert placements["fusion.blocks.0.ffn.fc1.weight"] == "(Shard(dim=0),)"
        assert placements["fusion.blocks.0.ffn.fc2.weight"] == "(Shard(dim=1),)"
        assert placements["fusion.blocks.0.attn.q.weight"] == "(Shard(dim=0),)"
        assert placements["fusion.blocks.0.attn.out.weight"] == "(Shard(dim=1),)"
        assert placements["box_decoder.blocks.0.cross_attn.k.weight"] == "(Shard(dim=0),)"
        assert placements["text_embed.weight"] == "(Shard(dim=0),)"
        assert placements["fusion.blocks.0.norm1.weight"] is None  # norms stay whole
        assert placements["routing_head.weight"] is None


DRYRUN = textwrap.dedent(r"""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from explainable_spatial_vqa_tpu_torch.parallel import multihost
    from explainable_spatial_vqa_tpu_torch.parallel.mesh import batch_sharding
    multihost.initialize(f"localhost:{port}", num_processes=1, process_id=0)
    assert multihost.process_count() == 1 and not multihost.is_multihost()

    mesh = multihost.make_global_mesh((-1,), ("data",))
    assert mesh.shape == {"data": 1} and mesh.group() is not None
    batch = {"x": np.arange(32, dtype=np.float32).reshape(16, 2), "p": np.float32(0.25)}
    g = multihost.global_batch(batch, mesh)
    assert tuple(g["x"].shape) == (16, 2) and tuple(g["p"].shape) == ()
    np.testing.assert_array_equal(g["x"].numpy(), batch["x"])
    assert batch_sharding(mesh, 16) == slice(0, 16)

    # one train step through the data-parallel trainer, against no group
    from explainable_spatial_vqa_tpu_torch.core.config import OptimConfig, TrainConfig
    from explainable_spatial_vqa_tpu_torch.train.data import Subset, batches
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    def loss_fn(model, b, generator, train):
        loss = torch.mean((model(b["x"]) - b["y"]) ** 2)
        return loss, {"answer_correct": 0, "answer_total": 1}

    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(64, 4).astype(np.float32), "y": rng.randn(64, 1).astype(np.float32)}
    sub = Subset(arrays, np.arange(64))
    model = torch.nn.Linear(4, 1)
    torch.nn.init.zeros_(model.weight)
    trainer = Trainer(loss_fn, model, OptimConfig(learning_rate=1e-2), TrainConfig(num_epochs=1),
                      checkpoint_dir=False, device="cpu")
    assert trainer.mesh.shape == {"data": 1} and not trainer.data_parallel
    pi, pc = multihost.process_index(), multihost.process_count()
    acc = trainer.train_epoch(batches(sub, 16, seed=0, process_index=pi, process_count=pc),
                              seed=0, epoch=0)
    assert np.isfinite(acc.mean("loss_sum"))
    print("MULTIHOST_DRYRUN_OK", acc.mean("loss_sum"))
""")


def test_process_count_1_cluster_dryrun():
    """tests/test_multihost.py's dry run on the port: a one-process group over
    gloo behaves as no group (global_batch is the identity, a trainer step
    runs)."""
    _spawn(DRYRUN, 1)
