"""The rank side of the port's multi-process tests
(`tests/test_torch_parallel_multiproc.py`, `test_torch_sharded_engine.py`,
`test_torch_sharded_paged_engine.py`).

`spawn(suite, inputs, tmp_path)` starts four gloo ranks on the CPU, each
`python tests/torch_parallel_ranks.py <suite> <rank> <world> <dir>` with one
thread, a `file://` rendezvous under `tmp_path` and the pickled numpy
`inputs`, joins them within a time limit (killing them all on expiry) and
returns each rank's pickled results. A rank imports torch, numpy and the
port only, never JAX: the tests hold the results against the JAX package
in their own process.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 240


def spawn(suite: str, inputs: dict, tmp_path, world: int = WORLD,
          timeout: float = TIMEOUT_S) -> list:
    """Each rank's results (a list by rank) of `suite` on `inputs`."""
    d = str(tmp_path)
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               suite, str(r), str(world), d], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"the {suite} ranks did not finish within "
                             f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, bad
    results = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [_np(v) for v in x]
    if hasattr(x, "_fields"):
        return type(x)(*(_np(v) for v in x))
    return x


def _qt(pair):
    import torch
    from flasht5_tpu_torch.ops.quant import QuantizedTensor
    return QuantizedTensor(torch.from_numpy(pair[0]),
                           torch.from_numpy(pair[1]))


def _batch_rows(batch, rows):
    import torch
    return {k: torch.from_numpy(v[rows]) for k, v in batch.items()}


def suite_ops(inp, out_dir):
    """The collective matmuls, the vocab-parallel loss and next token, the
    tensor-, data- and pipeline-parallel steps."""
    import torch
    import torch.distributed as dist

    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.convert import params_from_numpy
    from flasht5_tpu_torch.ops.quant import QuantizedTensor
    from flasht5_tpu_torch.parallel import pp_step, tp_step
    from flasht5_tpu_torch.parallel.collective_matmul import (
        allgather_matmul, matmul_reducescatter)
    from flasht5_tpu_torch.parallel.distributed import host_local_batch_slice
    from flasht5_tpu_torch.parallel.mesh import make_mesh, make_pp_mesh
    from flasht5_tpu_torch.parallel.sharding import (batch_slice,
                                                     gather_params,
                                                     gather_tree,
                                                     shard_params)
    from flasht5_tpu_torch.parallel.train_step import (make_train_step,
                                                       sharded_train_step)
    from flasht5_tpu_torch.parallel.vocab_parallel import (
        vocab_parallel_loss, vocab_parallel_next_token)

    res = {"batch_slice": host_local_batch_slice(10)}
    meshes = {4: make_mesh(1, 4), 2: make_mesh(2, 2)}
    g4 = meshes[4].get_group("tensor")
    r4 = dist.get_rank(g4)

    # ---- collective matmuls at t = 4 ----
    x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
    wq = _qt(inp["wq"])
    res["allgather"] = allgather_matmul(x.chunk(4)[r4], w, g4)
    res["allgather_int8"] = allgather_matmul(x.chunk(4)[r4], wq, g4)
    xs = x.chunk(4, dim=1)[r4].contiguous()
    res["reducescatter"] = matmul_reducescatter(
        xs, w.chunk(4, dim=0)[r4].contiguous(), g4)
    # a row-split weight keeps its per-channel scales whole
    wq_rows = QuantizedTensor(wq.qvalues.chunk(4, dim=0)[r4].contiguous(),
                              wq.scales)
    res["reducescatter_int8"] = matmul_reducescatter(xs, wq_rows, g4)

    # ---- the vocab-parallel loss, value and gradient ----
    for name, case in inp["ce_cases"].items():
        group = meshes[case["t"]].get_group("tensor")
        r = dist.get_rank(group)
        cfg = FlashT5Config(**case["config"])
        logits = torch.from_numpy(case["logits"])
        local = logits.chunk(case["t"], dim=-1)[r].clone().requires_grad_()
        loss = vocab_parallel_loss(cfg, local, torch.from_numpy(
            case["labels"]), group)
        loss.backward()
        res[f"ce_{name}"] = {"loss": loss, "grad": local.grad, "rank": r}

    # a planted fault: the split backward fed the shard's own lse
    from flasht5_tpu_torch.parallel import vocab_parallel
    real = vocab_parallel.split_backward

    def own_lse(logits, labels, lse, dloss, **kw):
        return real(logits, labels, torch.logsumexp(logits.float(), -1),
                    dloss, **kw)

    case = inp["ce_cases"][inp["ce_fault_case"]]
    group = meshes[case["t"]].get_group("tensor")
    local = torch.from_numpy(case["logits"]).chunk(case["t"], dim=-1)[
        dist.get_rank(group)].clone().requires_grad_()
    vocab_parallel.split_backward = own_lse
    try:
        vocab_parallel_loss(FlashT5Config(**case["config"]), local,
                            torch.from_numpy(case["labels"]),
                            group).backward()
    finally:
        vocab_parallel.split_backward = real
    res["ce_fault"] = {"grad": local.grad, "rank": dist.get_rank(group)}

    # ---- next token over the split vocabulary ----
    for t in (2, 4):
        group = meshes[t].get_group("tensor")
        r = dist.get_rank(group)
        logits = torch.from_numpy(inp["next_logits"])
        local = logits.chunk(t, dim=-1)[r].contiguous()
        res[f"next_greedy_{t}"] = vocab_parallel_next_token(local, group)
        gen = torch.Generator().manual_seed(7)
        res[f"next_sampled_{t}"] = vocab_parallel_next_token(
            local, group, generator=gen, temperature=0.8, top_k=20,
            top_p=0.9)

    # ---- the steps ----
    cfg = FlashT5Config(**inp["config"])
    full = params_from_numpy(inp["params"], device="cpu")
    m22 = meshes[2]
    res["roundtrip"] = gather_params(shard_params(full, m22), m22)
    batch = inp["batch"]
    for coll in (False, True):
        c = cfg.replace(use_collective_matmul=coll)
        params, opt = tp_step.tp_train_state(c, m22, params=full,
                                             learning_rate=1e-2,
                                             device="cpu")
        step = tp_step.make_tp_train_step(c, m22, opt)
        rows = _batch_rows(batch, batch_slice(m22, 8))
        losses = [step(params, rows)["loss"] for _ in range(2)]
        res[f"tp_{coll}"] = {"losses": losses,
                             "params": gather_params(params, m22)}
    # the gradients summed over "data" in bf16 (JAX `_sync_grad`)
    params, opt = tp_step.tp_train_state(cfg, m22, params=full,
                                         learning_rate=1e-2, device="cpu")
    step = tp_step.make_tp_train_step(cfg, m22, opt,
                                      allreduce_dtype="bfloat16")
    rows = _batch_rows(batch, batch_slice(m22, 8))
    losses = [step(params, rows)["loss"] for _ in range(2)]
    res["tp_bf16_allreduce"] = {"losses": losses,
                                "params": gather_params(params, m22)}
    m41 = make_mesh(4, 1)
    # one step end to end, its parameters drawn from seed 0
    for name, mesh in (("2x2", m22), ("4x1", m41), ("1x4", meshes[4])):
        res[f"sharded_{name}"] = sharded_train_step(
            cfg, mesh, batch["input_ids"], batch["labels"], device="cpu",
            seed=0)
    params, opt = tp_step.tp_train_state(cfg, m41, params=full,
                                         learning_rate=1e-2, device="cpu")
    step = make_train_step(cfg, m41, opt)
    rows = _batch_rows(batch, batch_slice(m41, 8))
    res["dp"] = {"losses": [step(params, rows)["loss"] for _ in range(2)],
                 "params": params}
    mp = make_pp_mesh(2, 2)
    params, opt = pp_step.pp_train_state(cfg, mp, params=full,
                                         learning_rate=1e-2, device="cpu")
    step = pp_step.make_pp_train_step(cfg, mp, opt, n_microbatches=2)
    rows = _batch_rows(batch, batch_slice(mp, 8))
    losses = [step(params, rows)["loss"] for _ in range(2)]
    pp_full = gather_tree(params, pp_step.pp_param_pspecs(params), mp,
                          "pipe")
    res["pp_step"] = {"losses": losses,
                 "params": pp_step.from_pp_params(pp_full)}
    return res


def suite_trainer(inp, out_dir):
    """The trainer at (data 2, tensor 2) and (pipe 2, data 2): training,
    evaluation, a checkpoint and its restore, dropout's generators."""
    import torch
    import torch.distributed as dist

    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.convert import params_from_numpy
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.train import Trainer, TrainerConfig

    cfg = FlashT5Config(**inp["config"])
    full = params_from_numpy(inp["params"], device="cpu")
    res = {}
    layouts = {"tp": dict(data_parallel=2, tensor_parallel=2),
               "pp": dict(data_parallel=2, pipeline_parallel=2,
                          pp_microbatches=2)}
    for name, layout in layouts.items():
        tcfg = TrainerConfig(**inp["trainer"], **layout,
                             output_dir=os.path.join(out_dir, name))
        tr = Trainer(cfg, tcfg, params=full, device="cpu")
        out = tr.train(inp["batches"])
        res[name] = {"logs": out["logs"], "params": tr.full_params(),
                     "eval": tr.evaluate(inp["eval_batches"])}
        path = tr.save_checkpoint(tr.step_num)
        again = Trainer(cfg, tcfg, device="cpu")
        again.restore_checkpoint(path)
        same = all(torch.equal(a, b)
                   for a, b in zip(again._leaves, tr._leaves))
        for p, q in zip(again._leaves, tr._leaves):
            for key, value in tr.optimizer.state[q].items():
                same &= torch.equal(again.optimizer.state[p][key], value)
        same &= again.optimizer.step_count == tr.optimizer.step_count
        res[name]["restored_equal"] = same
        res[name]["checkpoint"] = path
    # dropout: one mask on every tensor rank, others across "data"
    tcfg = TrainerConfig(**inp["trainer"], **layouts["tp"],
                         output_dir=os.path.join(out_dir, "dropout"))
    tr = Trainer(cfg.replace(dropout_rate=0.1), tcfg, params=full,
                 device="cpu")
    tr.train(inp["batches"][:1])
    tensor = tr.mesh.get_group("tensor")
    spread = 0.0
    for (_, p), split in zip(t5.tree_leaves_with_path(tr.params), tr._split):
        if not split:
            parts = [torch.empty_like(p) for _ in range(2)]
            dist.all_gather(parts, p.detach().contiguous(), group=tensor)
            spread = max(spread, float((parts[0] - parts[1]).abs().max()))
    res["dropout"] = {"whole_leaves_spread": spread,
                      "seed": tr.generator.initial_seed(),
                      "data": tr.mesh.get_local_rank("data"),
                      "tensor": tr.mesh.get_local_rank("tensor")}
    return res


class _Clock:
    """A rank's own clock for `run(now=...)`: `step` seconds a reading."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _serve_cases(inp, engine_cls, config_cls, with_probe):
    """Each case of `inp["cases"]` on `engine_cls` over its mesh: the
    served tokens by uid (and the deferred admissions), or probe steps."""
    import torch.distributed as dist

    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.convert import params_from_numpy
    from flasht5_tpu_torch.inference.engine import Request
    from flasht5_tpu_torch.inference.sharded_engine import make_serving_mesh

    params = {k: params_from_numpy(v, device="cpu")
              for k, v in inp["params"].items()}
    meshes, res = {}, {}
    for case in inp["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_serving_mesh(*shape)
        cfg = FlashT5Config(**{**inp["config"], **case.get("config", {})})
        ecfg = config_cls(**{**inp["ecfg"], **case.get("ecfg", {})})
        eng = engine_cls(cfg, params[case["params"]], ecfg, meshes[shape],
                         device="cpu")
        reqs = [Request(uid=u, input_ids=ids, max_new_tokens=m,
                        arrival_s=a)
                for u, ids, m, a in inp["requests"][case["requests"]]]
        if with_probe and case.get("probe"):
            for i, r in enumerate(reqs):
                eng.admit_request(r, i)
            res[case["name"]] = [eng.probe_step()
                                 for _ in range(case["probe"])]
            continue
        kw = {}
        if case.get("clock"):
            # every rank reads its own clock, each at another rate
            kw["now"] = _Clock(case["clock"] * (dist.get_rank() + 1))
        done = eng.run(reqs, **kw)
        res[case["name"]] = {
            "tokens": {r.uid: r.result for r in done},
            "deferrals": getattr(eng, "deferrals", None)}
    return res


def suite_serving(inp, out_dir):
    """The sharded slot engine's cases (tests/test_torch_sharded_engine)."""
    from flasht5_tpu_torch.inference.engine import EngineConfig
    from flasht5_tpu_torch.inference.sharded_engine import ShardedEngine
    return _serve_cases(inp, ShardedEngine, EngineConfig, True)


def suite_paged_serving(inp, out_dir):
    """The sharded paged engine's cases
    (tests/test_torch_sharded_paged_engine)."""
    from flasht5_tpu_torch.inference.paged_engine import PagedEngineConfig
    from flasht5_tpu_torch.inference.sharded_paged_engine import (
        ShardedPagedEngine)
    return _serve_cases(inp, ShardedPagedEngine, PagedEngineConfig, False)


def suite_all(inp, out_dir):
    return {**suite_ops(inp["ops"], out_dir),
            **suite_trainer(inp["trainer"], out_dir)}


SUITES = {"ops": suite_ops, "trainer": suite_trainer, "all": suite_all,
          "serving": suite_serving, "paged_serving": suite_paged_serving}


def main(argv) -> None:
    suite, rank, world, d = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from flasht5_tpu_torch.parallel.distributed import initialize_multihost
    initialize_multihost("file://" + os.path.join(d, "rendezvous"), world,
                         rank, device="cpu")
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = _np(SUITES[suite](inputs, d))
    dist.barrier()
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
