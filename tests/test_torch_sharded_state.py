"""The port's sharded train state against the JAX package.

Reduced fp32 configs, the JAX ``init_train_state`` carried across: the
``llama3.2-3b`` of ``prog_train_step.py`` (d_model 64, 4 heads, 2 KV
heads, vocab 96), ``phi3.5-moe`` with 4 experts under expert parallelism
(drop-free, no router loss) and in the dense dispatch with its router
loss (held against the mean of the data ranks' row blocks' JAX losses,
each router loss being over its rank's tokens), and ``zamba2-1.2b`` at 3
layers (a group and a tail; its ``ssm_inner`` split over ``model``),
batch 8 x 16 from a numpy seed.

* Without a spawn: every leaf's block on every rank of (2, 2, 2) and
  (2, 4), standard and pod-compressed, has the shape of JAX's
  ``NamedSharding(...).shard_shape`` under ``train_state_shardings``.
* One spawn of 8 gloo ranks (``tests/_torch_dist.py``): llama on pod 2 x
  data 2 x model 2, the MoEs on data 2 x model 4 (under EP an expert a
  ``model`` rank), zamba2 on the pod mesh; each rank holds only its blocks, and the
  step's loss and grad norm equal the JAX single-device step's within
  rtol 1e-5, its gathered params within 1e-5 where |g| > 1e-6 (the
  tolerances of ``test_standard_mesh_step_equals_the_single_device_step``),
  beside what AdamW's first step makes of the gradient's difference, the
  gradient AdamW got within 1e-5 of ``jax.grad`` (``_check_step``).
  ``vocab_parallel_embed`` on the 4 ``model`` ranks, each holding its
  block of the table (vocab 96) or the whole (vocab 98, a plain take),
  equals ``jnp.take`` and its gradient ``jax.grad``'s rows.
* The sequence-parallel layout (``model`` dividing S = 16): every
  decoder block takes the rank's stretch (B / 4, S / 2, D) of the
  stream.  A ragged llama (S = 15, ``model`` 2 does not divide it) keeps
  the stream whole and takes the vocab-parallel loss over (B / 4, 15,
  V / 2) logits; a dense-dispatch phi3.5-moe at capacity factor 0.5 on
  ``model`` 2 drops half its assignments, the ones the JAX dispatch of
  each data rank's rows drops.  Both against the JAX single-device step
  within the tolerances above.
* Prefill of a 20-token prompt (a chunk that straddles the two
  ``model`` ranks' stretches of a 32-position cache) and 4 greedy decode
  steps on a (data 2, model 2) mesh of sharded params (``mesh_params``),
  llama and zamba2, in the elastic spawn: the tokens equal the JAX
  single-device ``prefill_chunk`` + ``decode_step`` greedy tokens, the
  logits within 1e-5.
* Elastic restore: llama's state saved on (2, 2, 2) after step 1 restores
  ``torch.equal`` onto one device here and onto ``plan_elastic_mesh(4, 2,
  8) == (2, 2)`` in a spawn of 4 ranks; step 2 on each equals the
  unbroken 8-rank step 2 within 1e-5 (params where |g| > 1e-6).
* ``launch/train.py`` on 2 gloo ranks with ``--ckpt-dir`` saves, resumes
  and prints the one-process run's losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import _torch_dist
from repro.configs.registry import get_config as jget
from repro.models.common import init_params as jinit
from repro.models.registry import get_api as jget_api
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.adamw import adamw_update as jadamw_update
from repro.train import state as jstate
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import train_state_from_numpy
from repro_torch.ft.failures import plan_elastic_mesh
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import block_slices
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import state as tstate
from repro_torch.tree import map_tree

CONFIGS = {
    "llama": ("llama3.2-3b", {"n_kv_heads": 2, "vocab": 96, "d_model": 64,
                              "n_heads": 4}, "pod"),
    # no router loss: under EP it is the mean of the token blocks' losses,
    # as the JAX EP computes it (test_torch_moe_ep.py holds it there), not
    # the one-device step's loss over all the tokens
    "moe": ("phi3.5-moe-42b-a6.6b", {"n_experts": 4, "capacity_factor": 4.0,
                                     "use_ep": True, "vocab": 96,
                                     "router_aux_coef": 0.0}, "flat"),
    # the dense dispatch with its router loss: each data rank's loss over
    # its own rows, so the oracle is the mean of the row blocks' losses
    # (ROUTER_BLOCKS)
    "moe_dense": ("phi3.5-moe-42b-a6.6b", {"n_experts": 4,
                                           "capacity_factor": 4.0,
                                           "use_ep": False, "vocab": 96},
                  "flat"),
    "hybrid": ("zamba2-1.2b", {"n_layers": 3, "vocab": 96}, "pod"),
    # S = 15: model 2 does not divide the sequence, so the stream stays
    # whole and the logits split over the vocab (SEQ)
    "llama_ragged": ("llama3.2-3b", {"n_kv_heads": 2, "vocab": 96,
                                     "d_model": 64, "n_heads": 4}, "pod"),
    # capacity 0.5: half of every dispatch's assignments dropped, on the
    # whole sequence of each data rank's rows (ROUTER_BLOCKS)
    "moe_drop": ("phi3.5-moe-42b-a6.6b", {"n_experts": 4,
                                          "capacity_factor": 0.5,
                                          "use_ep": False, "vocab": 96},
                 "pod"),
}
#: the row blocks a config's oracle loss is the mean of: the data ranks
#: a router loss is computed over (1: the whole batch)
ROUTER_BLOCKS = {"moe_dense": 2, "moe_drop": 4}
#: the sequence length of a config's batches (S otherwise)
SEQ = {"llama_ragged": 15}
MESHES = {"pod": ((2, 2, 2), ("pod", "data", "model")),
          "flat": ((2, 4), ("data", "model"))}
B, S, LR = 8, 16, 1e-2


def _jcfg(name):
    arch, over, _ = CONFIGS[name]
    return jget(arch).reduced(dtype=jnp.float32, **over)


def _tcfg(name):
    arch, over, _ = CONFIGS[name]
    return tget(arch).reduced(dtype=torch.float32, **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed, seq=S):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, seq)).astype(np.int64)
            for k in ("tokens", "labels")}


def _jax_steps(cfg, state, batches, blocks=1):
    """The JAX single-device step from ``state`` over ``batches``: per step
    (metrics, params, the gradient of that step's loss).  The step is
    ``build_train_step``'s standard mode (``jax.value_and_grad`` of the
    loss, then ``adamw_update``), with the loss and its gradient compiled
    once; with ``blocks`` > 1 the loss is the mean of the losses of that
    many row blocks of the batch."""
    api = jget_api(cfg)

    def loss(p, b):
        n = B // blocks
        return sum(api.train_loss(p, {k: v[i * n:(i + 1) * n]
                                      for k, v in b.items()}, cfg)
                   for i in range(blocks)) / blocks

    opt_cfg = JAdamW(lr=LR, grad_clip=1.0)
    vg = jax.jit(jax.value_and_grad(loss))
    update = jax.jit(lambda st, g: jadamw_update(
        opt_cfg, st["params"], g,
        JAdamWState(step=st["step"], m=st["m"], v=st["v"])))
    out = []
    for b in batches:
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}
        value, grads = vg(state["params"], jb)
        params, opt, metrics = update(state, grads)
        metrics["loss"] = value
        state = {**state, "params": params, "m": opt.m, "v": opt.v,
                 "step": opt.step}
        out.append(_np((metrics, state["params"], grads)))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    payload, want = {}, {}
    for i, name in enumerate(CONFIGS):
        cfg = _jcfg(name)
        state = _np(jax.jit(lambda k: jstate.init_train_state(cfg, k))(
            jax.random.key(i)))
        seq = SEQ.get(name, S)
        batches = [_batch(cfg, 10 + i, seq), _batch(cfg, 20 + i, seq)]
        if name != "llama":
            batches = batches[:1]
        arch, over, mesh = CONFIGS[name]
        payload[name] = {"arch": arch, "over": over, "mesh": mesh,
                         "state": state, "batches": batches}
        want[name] = {"state": state, "batches": batches,
                      "steps": _jax_steps(cfg, state, batches,
                                          ROUTER_BLOCKS.get(name, 1))}
    payload["llama"]["ckpt"] = ckpt
    rng = np.random.default_rng(5)
    payload["embed"] = {}
    for vocab in (96, 98):
        payload["embed"][vocab] = {
            "table": rng.standard_normal((vocab, 16)).astype(np.float32),
            "tokens": rng.integers(0, vocab, (2, 12)).astype(np.int64),
            "c": rng.standard_normal((2, 12, 16)).astype(np.float32)}
    ranks = _torch_dist.run_ranks(8, "sharded_state_program", payload,
                                  tmp_path_factory.mktemp("sharded"))
    return {"want": want, "ranks": ranks, "ckpt": ckpt,
            "embed": payload["embed"]}


def _ok(ranks, case):
    out = []
    for r, res in enumerate(ranks):
        status, value = res[case]
        assert status == "ok", f"rank {r}:\n{value}"
        out.append(value)
    return out


def _firm_close(got, want, grads, extra=None, tol=1e-5):
    """Params within ``tol`` (and ``extra``, a tree like them) where |g| >
    1e-6; elsewhere AdamW's first step, lr * g / (|g| + eps), turns a
    reassociation into up to 2 * lr."""
    extra = extra or jax.tree.map(lambda g: 0.0, grads)
    for a, b, g, e in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                          jax.tree.leaves(grads), jax.tree.leaves(extra)):
        firm = np.abs(g) > 1e-6
        ok = np.abs(a - b) <= tol + tol * np.abs(b) + e
        assert np.all(ok[firm]), np.abs(a - b)[firm & ~ok]
        assert np.all(np.abs(a - b) <= 2 * LR)


def _first_update(g, norm):
    """What AdamW's first step adds to a param, but weight decay, per
    unit lr: u / (|u| + eps), u the clipped gradient (grad_clip 1.0)."""
    u = g * min(1.0, 1.0 / (float(norm) + 1e-9))
    return u / (np.abs(u) + 1e-8)


def _check_step(got, grads, want):
    """Loss and grad norm within rtol 1e-5; the gradient AdamW got within
    1e-5; the params within 1e-5 where |g| > 1e-6, beside what AdamW's
    first step makes of that gradient's difference (its slope, lr * eps /
    (|u| + eps)^2, turns 1e-7 of g at |g| near 1e-6 into 1e-5 of the
    param)."""
    metrics, params, _ = got
    jm, jparams, jgrads = want
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    extra = jax.tree.map(
        lambda a, b: LR * np.abs(_first_update(a, metrics["grad_norm"])
                                 - _first_update(b, jm["grad_norm"])),
        grads, jgrads)
    _firm_close(params, jparams, jgrads, extra)


class _Rank:
    """What ``block_slices`` reads of a device mesh, at one coordinate."""

    def __init__(self, shape, coord):
        shape = dict(shape)
        self.shape = shape
        self.axis_names = tuple(shape)
        self._coord = dict(zip(shape, coord))

    def index(self, axis):
        return self._coord[axis]

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def flat_index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self._coord[a]
        return i


@pytest.mark.parametrize("pod_compressed", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_block_shapes_equal_jax_shard_shapes(name, mesh, pod_compressed):
    sizes, names = MESHES[mesh]
    n_pods = sizes[0] if pod_compressed and "pod" in names else 1
    jcfg, tcfg = _jcfg(name), _tcfg(name)
    jsh = jstate.train_state_shardings(jcfg, AbstractMesh(sizes, names),
                                       pod_compressed=pod_compressed,
                                       n_pods=n_pods)
    jspecs = jstate.train_state_specs(jcfg, pod_compressed, n_pods)
    want = jax.tree.map(lambda sh, s: sh.shard_shape(s.shape), jsh, jspecs,
                        is_leaf=lambda x: isinstance(x, NamedSharding))
    tsh = tstate.train_state_shardings(tcfg, dict(zip(names, sizes)),
                                       pod_compressed=pod_compressed,
                                       n_pods=n_pods)
    tspecs = tstate.train_state_specs(tcfg, pod_compressed, n_pods)
    shapes = lambda t: jax.tree.leaves(
        t, is_leaf=lambda x: isinstance(x, tuple))
    whole = blocks = 0
    for coord in np.ndindex(*sizes):
        rank = _Rank(zip(names, sizes), coord)
        got = map_tree(lambda s, ps: tuple(
            x.stop - x.start for x in block_slices(s.shape, ps, rank)),
            tspecs, tsh)
        assert shapes(got) == shapes(want)
        for k in ("params", "m", "v"):
            for key in tstate.LAYER_KEYS:
                for s, shape in zip(jax.tree.leaves(tspecs[k].get(key, {})),
                                    shapes(got[k].get(key, {}))):
                    whole += int(np.prod(s.shape))
                    blocks += int(np.prod(shape))
    # a rank holds a part of the layers' params, m and v, not the whole
    assert blocks * 2 <= whole


def test_sharded_step_equals_the_single_device_step(setup):
    for name in CONFIGS:
        want = setup["want"][name]["steps"][0]
        for out in _ok(setup["ranks"], name):
            _check_step(out["steps"][0], out["grads"], want)


def test_ranks_hold_only_their_blocks(setup):
    for name in CONFIGS:
        sizes, names = MESHES[CONFIGS[name][2]]
        jsh = jstate.train_state_shardings(
            _jcfg(name), AbstractMesh(sizes, names))
        state = setup["want"][name]["state"]
        for out in _ok(setup["ranks"], name):
            for k in ("params", "m", "v"):
                flat = jax.tree_util.tree_flatten_with_path(state[k])[0]
                sh = jax.tree.leaves(
                    jsh[k], is_leaf=lambda x: isinstance(x, NamedSharding))
                for (path, leaf), s in zip(flat, sh):
                    key = "/".join(p.key for p in path)
                    assert out["blocks"][k][key] == s.shard_shape(
                        leaf.shape), (name, k, key)


def test_vocab_parallel_embed_and_its_gradient(setup):
    outs = _ok(setup["ranks"], "embed")
    for vocab, e in setup["embed"].items():
        table, tokens, c = (jnp.asarray(e[k]) for k in ("table", "tokens",
                                                        "c"))
        want = np.asarray(jnp.take(table, tokens, axis=0))
        grad = np.asarray(jax.grad(
            lambda t: jnp.sum(jnp.take(t, tokens, axis=0) * c))(table))
        for r, out in enumerate(outs):
            y, g = out[vocab]
            np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)
            if vocab % 4 == 0:         # the rank's rows: model rank r % 4
                m = r % 4
                grad_r = grad[m * vocab // 4:(m + 1) * vocab // 4]
            else:
                grad_r = grad
            np.testing.assert_allclose(g, grad_r, rtol=1e-6, atol=1e-6)


def test_the_stream_is_each_ranks_stretch_where_model_divides_it(setup):
    d = CONFIGS["llama"][1]["d_model"]
    for name, want in (("llama", (B // 4, S // 2, d)),
                       ("moe", (B // 2, S // 4, 64)),
                       ("llama_ragged", (B // 4, 15, d))):
        for out in _ok(setup["ranks"], name):
            assert out["stream"] == {want}, (name, out["stream"])
            assert out["vocab_ce"] == (
                {(B // 4, 15, 96 // 2)} if name == "llama_ragged" else set())


def test_ragged_sequence_takes_the_vocab_parallel_loss(setup):
    want = setup["want"]["llama_ragged"]["steps"][0]
    for out in _ok(setup["ranks"], "llama_ragged"):
        assert out["vocab_ce"] == {(B // 4, 15, 48)}
        _check_step(out["steps"][0], out["grads"], want)


def test_capacity_dropping_dense_moe_drops_as_jax(setup):
    from repro.models import moe as jmoe
    cfg = _jcfg("moe_drop")
    # 2 rows of 16 a data rank: 64 assignments for 4 x 8 places
    assert jmoe._capacity(2 * S, cfg) * cfg.n_experts < 2 * S * cfg.top_k
    want = setup["want"]["moe_drop"]["steps"][0]
    for out in _ok(setup["ranks"], "moe_drop"):
        _check_step(out["steps"][0], out["grads"], want)


#: prefill + greedy decode on (data 2, model 2): a prompt of PROMPT
#: tokens, DECODE_STEPS steps, a cache of SMAX positions
PROMPT, DECODE_STEPS, SMAX = 20, 4, 32
DECODE = {"llama": CONFIGS["llama"][:2],
          "hybrid": ("zamba2-1.2b", {"n_layers": 3, "vocab": 96})}


def _jax_decode(name):
    """The JAX single-device prefill and greedy decode of ``DECODE``'s
    config ``name``: the payload, and each call's logits and tokens."""
    arch, over = DECODE[name]
    cfg = jget(arch).reduced(dtype=jnp.float32, **over)
    api = jget_api(cfg)
    params = _np(jinit(api.param_specs(cfg), jax.random.key(7)))
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab, (4, PROMPT)).astype(np.int64)
    state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         api.decode_state_specs(cfg, 4, SMAX),
                         is_leaf=lambda x: hasattr(x, "axes"))
    prefill = jax.jit(lambda p, st, b: api.prefill_chunk(p, st, b, cfg))
    decode = jax.jit(lambda p, st, b: api.decode_step(p, st, b, cfg))
    logits, state = prefill(params, state, {
        "tokens": jnp.asarray(prompt, jnp.int32), "index": jnp.int32(0),
        "nvalid": jnp.int32(PROMPT)})
    out = [np.asarray(logits)]
    for i in range(DECODE_STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, state = decode(params, state, {
            "tokens": tok, "index": jnp.int32(PROMPT + i)})
        out.append(np.asarray(logits))
    out = np.stack(out)
    case = {"arch": arch, "over": over, "params": params, "prompt": prompt,
            "smax": SMAX, "steps": DECODE_STEPS}
    return case, (out, out.argmax(-1))


@pytest.fixture(scope="module")
def elastic(setup, tmp_path_factory):
    mesh = plan_elastic_mesh(4, 2, 8)
    arch, over, _ = CONFIGS["llama"]
    decode = {name: _jax_decode(name) for name in DECODE}
    ranks = _torch_dist.run_ranks(
        4, "elastic_program",
        {"arch": arch, "over": over, "mesh": mesh, "ckpt": setup["ckpt"],
         "batch": setup["want"]["llama"]["batches"][1],
         "decode": {k: v[0] for k, v in decode.items()}},
        tmp_path_factory.mktemp("elastic"))
    return mesh, ranks, {k: v[1] for k, v in decode.items()}


@pytest.mark.parametrize("name", sorted(DECODE))
def test_prefill_and_decode_on_a_mesh_of_sharded_params(elastic, name):
    mesh, ranks, want = elastic
    logits, tokens = want[name]
    for r, (got_logits, got_tokens) in enumerate(_ok(ranks,
                                                     f"decode_{name}")):
        rows = slice((r // 2) * 2, (r // 2) * 2 + 2)   # the data rank's
        np.testing.assert_array_equal(got_tokens, tokens[:, rows])
        np.testing.assert_allclose(got_logits, logits[:, rows], rtol=1e-5,
                                   atol=1e-5)


def _unbroken(setup):
    """The 8-rank run's state at the save and its step 2."""
    out = _ok(setup["ranks"], "llama")[0]
    return out["saved"], out["steps"][1]


def test_checkpoint_restores_onto_one_device(setup):
    saved, (metrics2, params2, _) = _unbroken(setup)
    target = train_state_from_numpy(setup["want"]["llama"]["state"], "cpu")
    state = restore_checkpoint(setup["ckpt"], 1, target)
    for a, b in zip(jax.tree.leaves(map_tree(lambda t: t.numpy(), state)),
                    jax.tree.leaves(saved)):
        assert torch.equal(torch.from_numpy(np.asarray(a)),
                           torch.from_numpy(np.asarray(b)))
    step = tstate.build_train_step(_tcfg("llama"),
                                   AdamWConfig(lr=LR, grad_clip=1.0))
    _, metrics = step(state, setup["want"]["llama"]["batches"][1])
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(metrics2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(metrics2["grad_norm"]), rtol=1e-5)
    grads = setup["want"]["llama"]["steps"][1][2]
    _firm_close(map_tree(lambda t: t.numpy(), state["params"]), params2,
                grads)


def test_checkpoint_restores_onto_the_elastic_mesh(setup, elastic):
    mesh, ranks, _ = elastic
    assert mesh == (2, 2)
    saved, (metrics2, params2, _) = _unbroken(setup)
    grads = setup["want"]["llama"]["steps"][1][2]
    for restored, (metrics, params) in _ok(ranks, "restore"):
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(saved)):
            assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(metrics2["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(metrics2["grad_norm"]), rtol=1e-5)
        _firm_close(params, params2, grads)


def test_train_cli_saves_and_resumes_on_a_mesh(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--seq", "16", "--batch", "4",
            "--ckpt-every", "2"]
    ranks = _torch_dist.run_ranks(
        2, "train_cli_program",
        {"argv": argv + ["--ckpt-dir", str(tmp_path / "ckpt")],
         "steps": (2, 4), "dir": str(tmp_path)}, tmp_path)
    first, resumed = (_ok(ranks, k) for k in ("first", "resumed"))
    assert "data=1xmodel=2" in first[0] and first[1] == ""
    assert "resumed from step 2" in resumed[0] and resumed[1] == ""
    assert tlaunch.main(argv + ["--steps", "4"]) == 0
    one = capsys.readouterr().out

    def losses(text):
        return [float(line.split()[3]) for line in text.splitlines()
                if line.startswith("step ")]
    np.testing.assert_allclose(losses(first[0]) + losses(resumed[0]),
                               losses(one), atol=2e-4)
