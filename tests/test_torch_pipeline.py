"""The port's pipeline stage runner (src/repro_torch/runtime/
pipeline_parallel.py) against the serial layer stack, the port's
``TrainEngine``, and repro's runner, on the CPU.

The stack is repro's test stack (tests/test_pipeline_parallel.py): L = 8
layers h -> tanh(h @ w) of width 16, a batch of 32, the loss the mean
squared error, the weights and data drawn with numpy from seeds.  S > 1
runs on 8 gloo ranks, a (S, 8 / S) ("stage", "data") mesh, in one spawn
for the file (torch on one thread a rank; the ranks import only torch
and the port), with the boundary cut on "data" (``x_spec``) unless said.

Bands, repro's own:
  the forward against the serial stack: bit for bit (each row's
      arithmetic is the serial stack's, layer by layer);
  the gradient through the schedule against the serial stack's: 5e-6 x
      max(|g|, 1e-3) (microbatch accumulation reassociates the sums);
  S = 1's trajectory against the port's engine: bit for bit (it is the
      engine); against repro's S = 1 runner: 1e-4 (verify/
      pipeline_cell.py's PIPE_LOSS_ATOL; the same arithmetic, two
      libraries);
  S = 2 and S = 4 against S = 1 over 4 AdamW steps: losses 1e-5
      relative, gnorms 1e-4 relative (tests/test_pipeline_parallel.py);
  bytes a rank sends per hop: the replicated boundary's exactly the inner
      degree times the cut one's."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import pipeline_parallel as pp
from repro_torch.train.engine import EngineConfig, TrainEngine

L, D, B = 8, 16, 32
N_MICRO, STEPS = 8, 4
OPT = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100)
WORLD = 8
STAGES = (2, 4)


def layer(p, h):
    return torch.tanh(h @ p["w"])


def loss_fn(h, y):
    return torch.mean((h - y) ** 2)


def _data():
    """(weights [L, D, D], x, t) as numpy, from a seed."""
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    t = rng.standard_normal((B, D)).astype(np.float32)
    return ws, x, t


def _serial(ws, x):
    for i in range(L):
        x = layer({"w": ws[i]}, x)
    return x


def _serial_loss(ws, x, t, n_micro):
    out = _serial(ws, x)
    mb = B // n_micro
    return torch.stack([loss_fn(out[i * mb:(i + 1) * mb],
                                t[i * mb:(i + 1) * mb])
                        for i in range(n_micro)]).mean()


def _trajectory(step, state):
    """STEPS steps on the batch (x, t): [(loss, gnorm)]."""
    _, x, t = _data()
    hist = []
    for _ in range(STEPS):
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(t))
        hist.append((float(m["loss"]), float(m["gnorm"])))
    return hist


# -- one process ---------------------------------------------------------------

def test_split_stages_and_stage_fn():
    """[L, ...] -> [S, L/S, ...]; a stage is its layers in turn; the flat
    path (no mesh) is the serial stack bit for bit, for any microbatch
    count; a stack that does not split raises."""
    ws, x, _ = _data()
    w, xt = torch.from_numpy(ws), torch.from_numpy(x)
    staged = pp.split_stages({"w": w}, 4)
    assert staged["w"].shape == (4, 2, D, D)
    stage = pp.make_stage_fn(layer)
    h = xt
    for s in range(4):
        h = stage({"w": staged["w"][s]}, h)
    assert torch.equal(h, _serial(w, xt))
    flat = pp.split_stages({"w": w}, 1)
    for n_micro in (1, 4, 8):
        out = pp.pipeline_forward(None, "stage", stage, flat, xt, n_micro)
        assert torch.equal(out, _serial(w, xt)), n_micro
    with pytest.raises(ValueError, match="do not split"):
        pp.split_stages({"w": w}, 3)


def test_s1_trainer_is_the_engine_bit_for_bit():
    """S = 1 delegates to the port's TrainEngine on the wrapped stack:
    every loss and gnorm of 4 steps of 8 microbatches equal the engine's
    own, and the stack the caller gave is left as it was."""
    ws, _, _ = _data()
    stack = {"w": torch.from_numpy(ws)}
    eng = TrainEngine(pp._StackModel(layer, loss_fn, stack),
                      EngineConfig(microbatches=N_MICRO, master_fp32=False,
                                   optim=OPT), device="cpu")
    want = _trajectory(lambda s, x, y: eng.step(s, {"x": x, "y": y}),
                       eng.init_state(0))
    tr = pp.PipelineTrainer(layer, loss_fn, n_stages=1, n_micro=N_MICRO,
                            optim=OPT, device="cpu")
    got = _trajectory(tr.step, tr.init(stack))
    assert got == want
    assert torch.equal(stack["w"], torch.from_numpy(ws))
    assert want[-1][0] < want[0][0]


def test_s1_trainer_tracks_repros():
    """repro's S = 1 runner (its engine on the same stack and batches):
    losses and gnorms within 1e-4 (PIPE_LOSS_ATOL)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
    from repro.runtime.pipeline_parallel import \
        PipelineTrainer as JaxPipelineTrainer
    from repro.verify.pipeline_cell import PIPE_LOSS_ATOL
    ws, x, t = _data()
    jtr = JaxPipelineTrainer(
        lambda w, h: jnp.tanh(h @ w), lambda h, y: jnp.mean((h - y) ** 2),
        n_stages=1, n_micro=N_MICRO,
        optim=JaxAdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100))
    st = jtr.init(jnp.asarray(ws))
    want = []
    for _ in range(STEPS):
        st, m = jtr.step(st, jnp.asarray(x), jnp.asarray(t))
        want.append((float(m["loss"]), float(m["gnorm"])))
    tr = pp.PipelineTrainer(layer, loss_fn, n_stages=1, n_micro=N_MICRO,
                            optim=OPT, device="cpu")
    got = _trajectory(tr.step, tr.init({"w": torch.from_numpy(ws)}))
    np.testing.assert_allclose(got, want, atol=PIPE_LOSS_ATOL, rtol=0)


def test_stage_tensor_spec_is_repros():
    """On the pipeline conformance cell's graph (8 layers of 512, batch 64,
    8 microbatches, a (4, 2) "pod" x "data" mesh with repro's bandwidths),
    each package's ``solve_pipeline`` picks 4 stages at the same cuts, and
    ``stage_tensor_spec`` gives the boundary activation and a stacked
    weight the placements of repro's PartitionSpecs over the inner dim."""
    pytest.importorskip("jax")
    from repro.core.builders import mlp_graph as jax_mlp_graph
    from repro.core.solver import MeshAxis as JaxMeshAxis
    from repro.core.solver import solve_pipeline as jax_solve_pipeline
    from repro.runtime.pipeline_parallel import \
        stage_tensor_spec as jax_stage_tensor_spec
    from repro.verify import pipeline_cell as cell
    from repro_torch.core.builders import mlp_graph
    from repro_torch.core.solver import MeshAxis, solve_pipeline
    from repro_torch.models.sharding import spec_placements
    # repro's mesh_to_solver_axes for (4, 2) ("pod", "data"): DCN, ICI
    axes = [("pod", 4, 6.25e9), ("data", 2, 1e11)]
    widths = [cell.D_MODEL] * (cell.LAYERS + 1)
    kw = dict(n_micro=cell.N_MICRO, stage_counts=cell.STAGE_COUNTS,
              mem_scale=0.0)
    jg = jax_mlp_graph(cell.BATCH, widths, with_backward=True)
    jsol = jax_solve_pipeline(jg, [JaxMeshAxis(*a) for a in axes], **kw)
    g = mlp_graph(cell.BATCH, widths, with_backward=True)
    sol = solve_pipeline(g, [MeshAxis(*a) for a in axes], **kw)
    assert (sol.n_stages, sol.cuts) == (jsol.n_stages, jsol.cuts)
    assert sol.n_stages == 4 and [a.name for a in sol.inner_axes] == ["data"]
    bt = next(t for t in sol.stages[1].incoming
              if g.tensors[t].kind == "activation")
    w = next(t for t in g.tensors if g.tensors[t].kind == "weight")
    for name, dims in ((bt, g.tensors[bt].dims),
                       (w, (None,) + tuple(g.tensors[w].dims))):
        want = jax_stage_tensor_spec(jsol, name, dims)
        got = pp.stage_tensor_spec(sol, name, dims)
        assert got == spec_placements(tuple(want), ["data"]), name
    from torch.distributed.tensor import Shard
    assert pp.stage_tensor_spec(sol, bt, g.tensors[bt].dims) == [Shard(0)]


# -- S > 1 on 8 gloo ranks -------------------------------------------------------

def _rank_main(rank, world, path):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import make_mesh
    ws, x, t = _data()
    w, xt, tt = (torch.from_numpy(a) for a in (ws, x, t))
    cut = [Shard(0)]
    out = {}
    for s in STAGES:
        mesh = make_mesh((s, world // s), ("stage", "data"), "cpu")
        stage = pp.make_stage_fn(layer)
        tr = pp.PipelineTrainer(layer, loss_fn, n_stages=s, n_micro=1,
                                mesh=mesh, optim=OPT, x_spec=cut,
                                device="cpu")
        staged = tr.place(pp.split_stages({"w": w}, s))
        for n_micro in sorted({1, s, 2 * s}):
            fwd = pp.pipeline_forward(mesh, "stage", stage, staged, xt,
                                      n_micro, x_spec=cut)
            p = staged["w"]
            p.requires_grad_(True)
            y = pp.pipeline_forward(mesh, "stage", stage, {"w": p}, xt,
                                    n_micro, x_spec=cut)
            mb = B // n_micro
            loss = torch.stack([loss_fn(y[i * mb:(i + 1) * mb],
                                        tt[i * mb:(i + 1) * mb])
                                for i in range(n_micro)]).mean()
            (g,) = torch.autograd.grad(loss, [p])
            g = g.redistribute(mesh, p.placements).full_tensor()
            out[("fwd", s, n_micro)] = fwd
            out[("grad", s, n_micro)] = g.reshape(L, D, D)
        tr = pp.PipelineTrainer(layer, loss_fn, n_stages=s,
                                n_micro=N_MICRO, mesh=mesh, optim=OPT,
                                x_spec=cut, device="cpu")
        out[("train", s)] = _trajectory(tr.step, tr.init({"w": w}))
    # one step at S = 4 with the boundary cut and with it replicated: the
    # bytes each rank sends over the stage boundaries
    mesh = make_mesh((4, 2), ("stage", "data"), "cpu")
    for tag, spec in (("cut", cut), ("replicated", None)):
        tr = pp.PipelineTrainer(layer, loss_fn, n_stages=4,
                                n_micro=N_MICRO, mesh=mesh, optim=OPT,
                                x_spec=spec, device="cpu")
        state = tr.init({"w": w})
        pp.reset_hop_bytes()
        tr.step(state, xt, tt)
        sent = [None] * world
        dist.all_gather_object(sent, (mesh.get_coordinate(),
                                      dict(pp.hop_bytes)))
        out[("bytes", tag)] = sent
    if rank == 0:
        torch.save(out, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline_ranks") / "out.pt"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spawn(_rank_main, WORLD, "cpu", (str(path),))
    finally:
        torch.set_num_threads(n)
    return torch.load(path, weights_only=False)


@pytest.mark.parametrize("s", STAGES)
def test_forward_bitwise_and_grads_vs_serial(ranks, s):
    """The schedule's forward on every microbatch count {1, S, 2S} is the
    serial stack bit for bit; the gradient through it within repro's
    band of the serial gradient."""
    ws, x, t = _data()
    w = torch.from_numpy(ws).requires_grad_(True)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    ref = _serial(w.detach(), xt)
    for n_micro in sorted({1, s, 2 * s}):
        assert torch.equal(ranks[("fwd", s, n_micro)], ref), n_micro
        (gs,) = torch.autograd.grad(_serial_loss(w, xt, tt, n_micro), [w])
        err = float((ranks[("grad", s, n_micro)] - gs).abs().max())
        assert err <= 5e-6 * max(float(gs.abs().max()), 1e-3), \
            (n_micro, err)


@pytest.mark.parametrize("s", STAGES)
def test_trainer_tracks_the_flat_engine(ranks, s):
    """4 AdamW steps of 8 microbatches through the S-stage schedule:
    losses within 1e-5 relative and gnorms within 1e-4 relative of S = 1
    (the engine's), and the loss falls."""
    ws, _, _ = _data()
    tr = pp.PipelineTrainer(layer, loss_fn, n_stages=1, n_micro=N_MICRO,
                            optim=OPT, device="cpu")
    want = _trajectory(tr.step, tr.init({"w": torch.from_numpy(ws)}))
    got = ranks[("train", s)]
    for (la, ga), (lb, gb) in zip(got, want):
        assert abs(la - lb) <= 1e-5 * max(abs(lb), 1e-3), (got, want)
        assert abs(ga - gb) <= 1e-4 * max(abs(gb), 1e-3), (got, want)
    assert got[-1][0] < got[0][0]


def test_boundary_cut_divides_the_hop_bytes(ranks):
    """At S = 4 on the (4, 2) mesh, one step of 8 microbatches of 4 rows:
    each stage but the last sends its 8 outputs forward and each but the
    first its 8 input gradients back, 4 x 16 f32 a microbatch with the
    boundary replicated, half of it with the boundary cut on "data" (the
    inner degree, 2)."""
    mb, itemsize, inner = B // N_MICRO, 4, 2
    full = N_MICRO * mb * D * itemsize
    for tag, per in (("replicated", full), ("cut", full // inner)):
        for (stage, _), sent in ranks[("bytes", tag)]:
            assert sent["forward"] == (per if stage < 3 else 0), tag
            assert sent["backward"] == (per if stage > 0 else 0), tag
    rep = {tuple(c): b for c, b in ranks[("bytes", "replicated")]}
    for c, b in ranks[("bytes", "cut")]:
        for k in ("forward", "backward"):
            assert b[k] * inner == rep[tuple(c)][k]
