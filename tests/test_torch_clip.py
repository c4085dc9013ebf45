"""CLIP guidance in the port (utils/clip_guidance.py and the trainer's
`clip_step`) against the JAX package's CLIPLoss and Trainer.clip_step, in
CLIP's random_init mode (no weights to download). Skips where
`transformers` does not import, as tests/test_clip.py does.

- The loss: both hold the same random CLIP weights and prompt; the loss and
  its gradient in the image agree within 1e-6 (the same torch model runs
  on both sides; the port's preprocessing is a copy).
- One `clip_step` in each package from one params tree, EMA and occupancy
  (test_torch_train_step.py's scene, [N, K] grid branch), the reference
  eagerly (see test_torch_train_step.py for why): the same random pose,
  focal rescale and white background give the loss within 1e-6 and each
  leaf's gradient within 1e-2 of its largest entry (the train-step parity
  tolerance). The reference backpropagates an image cotangent through a
  render VJP, the port the loss through the render itself. After the Adam
  step (eps 1e-15, so every entry moves by +-lr on the first step), params
  and EMA agree within 1e-6 wherever the reference's gradient is larger
  than twice that tolerance (its sign is then certain), and elsewhere
  within the 2 lr of an entry whose tiny gradient flips sign.
- The train loop with rand_pose 2, 4 steps side by side from there, the
  gt steps on the reference's pixels and jitter: the same order of gt and
  guided steps, the same step counter, each guided and gt loss within
  1e-5, and in each leaf of the params and EMA at most
  2% of the entries off by more than 0.1 lr (Adam's later steps spread the
  first step's sign flips through the MLPs).
- One port `clip_step` on a tiny trainer moves the params and counts a
  step, and the loop in clip-only mode (rand_pose 0) runs guided steps, as
  tests/test_clip.py checks the JAX trainer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.utils.clip_guidance import CLIPLoss as JCLIPLoss
from seal3d_tpu_torch.data.synthetic import SyntheticScene
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions
from seal3d_tpu_torch.train.checkpoint import flatten_tree
from seal3d_tpu_torch.train.trainer import StepRandom, TrainConfig, Trainer
from seal3d_tpu_torch.utils.clip_guidance import CLIPLoss as TCLIPLoss
from test_torch_train_step import NUM_RAYS, _trainers, scene  # noqa: F401

TOL = 1e-6
PROMPT = "a red chair"
CLIP_SIZE = 24
GRAD_TOL = 1e-2          # measured <= 4.6e-3 (sigma_net/0/w, encoders)
LOOP_LOSS_TOL = 1e-5     # measured <= 6.5e-7 guided, 3.4e-7 gt
LOOP_ENTRY_TOL = 0.1     # of lr
LOOP_SHARE = 0.02        # measured <= 1.1% (encoder_color)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def losses():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        jl = JCLIPLoss(PROMPT, random_init=True)
        tl = TCLIPLoss(PROMPT, random_init=True, device="cpu")
    if not (jl.available and tl.available):
        pytest.skip("transformers/torch CLIP unavailable")
    tl.model.load_state_dict(jl.model.state_dict())
    tl.prepare_text(PROMPT)
    return jl, tl


def test_clip_loss_and_image_gradient_match_jax(losses):
    jl, tl = losses
    img = np.random.default_rng(0).uniform(0, 1, (48, 40, 3)).astype(
        np.float32)
    want, want_g = jl.loss_and_grad(img)
    assert abs(tl(img) - jl(img)) <= TOL
    x = torch.from_numpy(img).requires_grad_(True)
    loss = tl.loss_torch(x)
    (g,) = torch.autograd.grad(loss, x)
    assert abs(float(loss.detach()) - want) <= TOL
    np.testing.assert_allclose(g.numpy(), want_g,
                               atol=TOL * np.abs(want_g).max())
    assert np.abs(want_g).max() > 0
    # another prompt, another loss; re-preparing restores it
    tl.prepare_text("a blue ocean wave")
    assert tl(img) != pytest.approx(want, abs=1e-6)
    tl.prepare_text(PROMPT)
    assert abs(tl(img) - want) <= TOL


def test_unavailable_without_a_model():
    cl = TCLIPLoss(PROMPT)
    assert not cl.available
    with pytest.raises(RuntimeError, match="prepared"):
        cl.loss_torch(torch.zeros(8, 8, 3))


def test_clip_step_moves_the_field(losses):
    _, tl = losses
    ds = SyntheticScene().make_dataset(n_views=2, h=16, w=16, seed=0)
    cfg = tngp.NGPConfig(bound=1.0, log2_hashmap_size=12, num_levels=4)
    opts = RenderOptions(bound=1.0, dt_gamma=0.0, max_steps=256,
                         budget_per_ray=16, num_candidates=64, min_near=0.05,
                         occ_stride=4)
    tcfg = TrainConfig(lr=1e-2, max_steps=100, num_rays=64, rand_pose=0,
                       clip_size=24)
    tr = Trainer(tngp, cfg, opts, tcfg, dataset=ds, device="cpu",
                 clip_loss=tl)
    tr.init_state()
    tr.update_grid(full=True)
    before = {k: v.clone() for k, v in flatten_tree(tr.state.params)}
    loss = tr.clip_step()
    assert np.isfinite(loss)
    moved = [k for k, v in flatten_tree(tr.state.params)
             if not torch.equal(v, before[k])]
    assert "color_net/0/w" in moved and "encoder" in moved, moved
    assert int(tr.state.step) == 1
    # clip-only mode: every loop step is a guided one
    tr.train(steps=2)
    assert int(tr.state.step) == 3
    # one guided step after every two gt steps
    tr.cfg = dataclasses.replace(tcfg, rand_pose=2)
    tr.train(steps=4)
    assert int(tr.state.step) == 3 + 4 + 2


def _clip_pair(scene, losses, rand_pose):  # noqa: F811
    """A JAX and a port trainer with one params tree, EMA (= the params)
    and occupancy, and the same CLIP loss. Both log each optimizer step as
    ("gt" | "clip", its loss); the port keeps every step's gradients and
    the reference its guided steps' (its gt gradients stay inside
    _train_step). The reference's gt steps run eagerly; their keys are
    kept so that the port's gt steps draw the same pixels and jitter."""
    jl, tl = losses
    jtr, ttr = _trainers(scene, "xla", "hash", None)
    # a copy: the reference's guided update donates the state it is given
    jtr.state = jax.tree.map(jnp.copy, jtr.state._replace(
        ema_params=jtr.state.params))
    ttr.state = ttr.state._replace(ema_params=ttr.state.params)
    for tr, cl in ((jtr, jl), (ttr, tl)):
        tr.cfg = dataclasses.replace(tr.cfg, rand_pose=rand_pose,
                                     clip_size=CLIP_SIZE)
        tr.clip_loss = cl
    jtr._build_clip_step()
    log = {"jax": [], "port": [], "jax_grads": [], "port_grads": [],
           "keys": []}
    japply, jstep, jclip = (jtr._apply_ext_grads, jtr._train_step,
                            jtr.clip_step)
    tapply, tstep, tclip = ttr._apply_grads, ttr.train_step, ttr.clip_step

    def j_apply(st, grads):
        log["jax_grads"].append(jax.tree.map(np.asarray, grads))
        return japply(st, grads)

    def j_step(st, key):
        log["keys"].append(key)
        st, m = jstep(st, key)
        log["jax"].append(("gt", float(m["loss"])))
        return st, m

    def j_clip():
        with jax.disable_jit():
            loss = jclip()
        log["jax"].append(("clip", loss))
        return loss

    def t_apply(st, grads):
        log["port_grads"].append(dict(flatten_tree(grads)))
        return tapply(st, grads)

    def t_step(rand=None):
        kimg, kray, _, kjit = jax.random.split(log["keys"].pop(0), 4)
        ds = scene[0]
        img_idx = int(jax.random.randint(kimg, (), 0, len(ds)))
        rays = j_get_rays(kray, jnp.asarray(ds.poses)[img_idx],
                          jnp.asarray(ds.intrinsics), ds.h, ds.w, NUM_RAYS)
        m = tstep(StepRandom(
            img_idx=torch.tensor(img_idx),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=torch.from_numpy(np.array(
                jax.random.uniform(kjit, (NUM_RAYS,))))))
        log["port"].append(("gt", float(m["loss"])))
        return m

    def t_clip():
        loss = tclip()
        log["port"].append(("clip", loss))
        return loss

    jtr._apply_ext_grads, jtr._train_step, jtr.clip_step = (j_apply, j_step,
                                                             j_clip)
    ttr._apply_grads, ttr.train_step, ttr.clip_step = t_apply, t_step, t_clip
    return jtr, ttr, log


def _signed(jgrads, names):
    """Per leaf, where the reference's gradient is larger than twice the
    gradient tolerance of the leaf's largest entry: its sign, and so the
    direction of Adam's step, cannot differ between the packages."""
    return {k: np.abs(np.asarray(g)) > 2 * GRAD_TOL * np.abs(g).max()
            for k, g in zip(names, jax.tree.leaves(jgrads))}


def _compare_params(jtr, ttr, certain):
    """Params and EMA after one Adam step: within TOL where the step's
    direction is certain, a few entries elsewhere within the 2 lr of a
    flipped sign."""
    for tree in ("params", "ema_params"):
        want = jax.tree.leaves(getattr(jtr.state, tree))
        got = flatten_tree(getattr(ttr.state, tree))
        for (k, t), j in zip(got, want):
            diff = np.abs(t.numpy() - np.asarray(j))
            sure = certain[k]
            assert diff[sure].max() <= TOL, (tree, k, diff[sure].max())
            assert diff.max() <= 2 * ttr.cfg.lr + TOL, (tree, k, diff.max())
            assert (diff > TOL).mean() <= 1e-3, (tree, k, (diff > TOL).sum())


def test_clip_step_matches_jax(scene, losses):  # noqa: F811
    jtr, ttr, log = _clip_pair(scene, losses, rand_pose=0)
    jloss = jtr.clip_step()
    tloss = ttr.clip_step()
    assert abs(tloss - jloss) <= TOL, (jloss, tloss)
    assert int(jtr.state.step) == int(ttr.state.step) == 1
    names = [k for k, _ in flatten_tree(ttr.state.params)]
    (jg,), (tg,) = log["jax_grads"], log["port_grads"]
    for k, ref in zip(names, jax.tree.leaves(jg)):
        scale = float(np.abs(ref).max())
        assert scale > 0, k
        np.testing.assert_allclose(tg[k].numpy() / scale, ref / scale,
                                   atol=GRAD_TOL, err_msg=k)
    _compare_params(jtr, ttr, _signed(jg, names))


def test_rand_pose_loop_matches_jax(scene, losses):  # noqa: F811
    jtr, ttr, log = _clip_pair(scene, losses, rand_pose=2)
    # from step 1, so that no grid update (random numbers of its own)
    # falls inside the 4 loop steps
    jtr.clip_step()
    ttr.clip_step()
    with jax.disable_jit():
        jtr.train(steps=4, silent=True)
    ttr.train(steps=4)
    kinds = [k for k, _ in log["jax"]]
    assert kinds == [k for k, _ in log["port"]]
    assert kinds == ["clip", "gt", "gt", "clip", "gt", "gt", "clip"]
    assert int(jtr.state.step) == int(ttr.state.step) == 7
    for (kind, a), (_, b) in zip(log["jax"], log["port"]):
        assert abs(a - b) <= LOOP_LOSS_TOL, (kind, a, b)
    # Adam's steps amplify the few sign flips of the first guided step
    # (+-2 lr each) through the MLPs: share of entries off by > 0.1 lr
    lr = ttr.cfg.lr
    for tree in ("params", "ema_params"):
        for (k, t), j in zip(flatten_tree(getattr(ttr.state, tree)),
                             jax.tree.leaves(getattr(jtr.state, tree))):
            off = np.abs(t.numpy() - np.asarray(j)) > LOOP_ENTRY_TOL * lr
            assert off.mean() <= LOOP_SHARE, (tree, k, off.mean())
