"""The port's FLAME fitting (``lets_face_it_tpu_torch/features/{flame_fit,
ringnet_lite,lipsync}.py``) against the JAX package's on the CPU, on
``synthetic_flame_model(160, seed=1)`` crossed through
``flame_model_from_arrays`` and the JAX embedding crossed through
``landmark_embedding_from_arrays``, so both sides fit the same head.

What is held, and how tightly (each limit beside the largest difference
read on these inputs):

- the anchor restriction, the landmarks (both branches) and the objective:
  landmarks atol 2e-6 (read 4.8e-07); value rtol 1e-5, gradient rtol 1e-5
  atol 1e-5 (``tests/test_flame_fit.py``'s limits for the JAX package's two
  paths; read 1.0e-07 relative), also at the zero rotation every fit starts
  from;
- the L-BFGS stages from a common start: stage 1 after 2 steps, stage 2
  after 3, parameters atol 1e-4 (read 2.6e-05), losses rtol 1e-5;
- whole fits (two stages of 30 + 60 steps): the objective is badly
  conditioned (scale ~900 beside rotations ~0.1), so rounding differences
  of one ulp grow through the line searches' branches into different,
  equally converged fits; the JAX package's own two paths (the restricted
  and the full objective, equal to an ulp) end 2.0e-03 apart in loss and
  8.8e-03 in rotation after 10 stage-2 steps from one start, the port and
  JAX 6.9e-03 and 1.7e-02. So a whole fit is held by its quality, as the
  JAX package's tests hold theirs: frames of a rigid pose recovered
  (loss < 1e-3, landmarks within 2 % of their spread, rotation within 5e-3
  of the truth; read 3.3e-03, JAX 3.6e-03), and over 24 frames with shape
  and expression the median and 95th percentile of the landmark RMS within
  15 % of JAX's (read 6.475 and 8.514 px against 6.428 and 8.314: 0.7 % and
  2.4 %), the median loss within 15 % (read 2.8 %);
- ``fit_to_vertices`` after 2 steps atol 1e-6 (read 2.5e-08; by step 4
  the same conditioning has the two 1.5e-04 apart), after 150 the JAX
  test's recovery limits; ``EnvelopeLipsync`` meshes atol 1e-5;
  ``estimate_init`` after 2 rigid and 5 shape steps atol 1e-4.
"""

import csv

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.features import flame_fit as jfit
from lets_face_it_tpu.features import lipsync as jlip
from lets_face_it_tpu.features import ringnet_lite as jring
from lets_face_it_tpu.render import flame as jflame
from lets_face_it_tpu_torch.features import flame_fit as fit
from lets_face_it_tpu_torch.features import lipsync, ringnet_lite
from lets_face_it_tpu_torch.render import flame as pflame

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The fits are thousands of small operations, which threads do not
    speed up; beside other test workers on the same cores they slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

JM = jflame.synthetic_flame_model(160, seed=1)
JE = jfit.synthetic_landmark_embedding(JM, seed=2)
KEYS = ("trans", "rot", "pose", "shape", "exp")


@pytest.fixture(scope="module")
def head():
    model = pflame.flame_model_from_arrays(
        {k: np.asarray(v) for k, v in JM._asdict().items()}, device="cpu")
    emb = fit.landmark_embedding_from_arrays(JE.vertex_ids, np.asarray(JE.bary),
                                             device="cpu")
    return model, emb


def _random_params(rng, n, scale=700.0):
    p = {"trans": rng.uniform(-0.05, 0.05, (n, 3)),
         "rot": rng.uniform(-0.3, 0.3, (n, 3)),
         "pose": rng.uniform(-0.2, 0.2, (n, 12)),
         "shape": rng.normal(0, 0.5, (n, 300)),
         "exp": rng.normal(0, 0.5, (n, 100)),
         "scale": np.full(n, scale)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _targets(seed, n, rigid_only, scale=900.0):
    """Landmarks of known parameters, projected by the JAX package."""
    rng = np.random.default_rng(seed)
    gt = {"trans": rng.uniform(-0.05, 0.05, (n, 3)),
          "rot": rng.uniform(-0.2, 0.2, (n, 3)), "pose": np.zeros((n, 12)),
          "shape": np.zeros((n, 300)) if rigid_only else rng.normal(0, .3, (n, 300)),
          "exp": np.zeros((n, 100)) if rigid_only else rng.normal(0, .3, (n, 100))}
    gt = {k: jnp.asarray(v, jnp.float32) for k, v in gt.items()}
    lmks = jax.vmap(lambda p: scale * jfit.model_landmarks(JM, JE, p)[:, :2])(gt)
    return np.asarray(lmks), {k: np.asarray(v) for k, v in gt.items()}


def _jax_rows(params, i):
    return {k: jnp.asarray(v[i]) for k, v in params.items()}


def _t(params):
    return {k: torch.as_tensor(v) for k, v in params.items()}


def _reprojected(model, emb, params):
    with torch.no_grad():
        lmks = fit.model_landmarks(model, emb, params)
        return (params["scale"][:, None, None] * lmks[..., :2]).numpy()


def _rms(proj, targets):
    return np.sqrt(((proj - targets) ** 2).sum(-1).mean(-1))


# ---------------------------------------------------------------------------
# The head, the restriction, the objective
# ---------------------------------------------------------------------------

def test_synthetic_embedding_and_crossing_are_bit_for_bit(head):
    model, emb = head
    native = fit.synthetic_landmark_embedding(
        pflame.synthetic_flame_model(160, seed=1, device="cpu"), seed=2)
    for e in (emb, native):
        np.testing.assert_array_equal(e.vertex_ids, JE.vertex_ids)
        np.testing.assert_array_equal(e.bary.numpy(), np.asarray(JE.bary))
    np.testing.assert_array_equal(model.v_template.numpy(), np.asarray(JM.v_template))


def test_restrict_to_landmarks_matches_jax(head):
    model, emb = head
    rj, ej = jfit.restrict_to_landmarks(JM, JE)
    rp, ep = fit.restrict_to_landmarks(model, emb)
    np.testing.assert_array_equal(ep.vertex_ids, ej.vertex_ids)
    for name, a in rj._asdict().items():
        np.testing.assert_allclose(getattr(rp, name).numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("restricted", [True, False])
def test_model_landmarks_match_jax(head, restricted):
    model, emb = head
    jm, je = jfit.restrict_to_landmarks(JM, JE) if restricted else (JM, JE)
    pm, pe = fit.restrict_to_landmarks(model, emb) if restricted else (model, emb)
    params = _random_params(np.random.default_rng(5), 3)
    got = fit.model_landmarks(pm, pe, _t(params)).numpy()
    for i in range(3):
        ref = np.asarray(jfit.model_landmarks(jm, je, _jax_rows(params, i)))
        np.testing.assert_allclose(got[i], ref, atol=2e-6)


def _objective_pair(restricted, head, params, target):
    model, emb = head
    jm, je = jfit.restrict_to_landmarks(JM, JE) if restricted else (JM, JE)
    pm, pe = fit.restrict_to_landmarks(model, emb) if restricted else (model, emb)
    out = []
    for i in range(target.shape[0]):
        v, g = jax.value_and_grad(
            lambda q: jfit._lmk_dist(jm, je, q, jnp.asarray(target[i]))
            + jfit._regularizers(q))(_jax_rows(params, i))
        pt = {k: torch.as_tensor(v_[i:i + 1]).requires_grad_(True)
              for k, v_ in params.items()}
        lv = (fit._lmk_dist(pm, pe, pt, torch.as_tensor(target[i:i + 1]))
              + fit._regularizers(pt))
        grads = torch.autograd.grad(lv.sum(), list(pt.values()))
        out.append((float(v), {k: np.asarray(g[k]) for k in g}, lv.item(),
                    {k: gr[0].numpy() for k, gr in zip(pt, grads)}))
    return out


@pytest.mark.parametrize("restricted", [True, False])
def test_objective_value_and_gradient_match_jax(head, restricted):
    rng = np.random.default_rng(6)
    params = _random_params(rng, 3)
    target = rng.uniform(0, 900, (3, 51, 2)).astype(np.float32)
    for v_j, g_j, v_p, g_p in _objective_pair(restricted, head, params, target):
        np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
        for k in g_j:
            np.testing.assert_allclose(g_p[k], g_j[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_gradient_at_zero_rotation_matches_jax(head):
    """Every fit starts at rot = 0, where ``rodrigues`` takes its Taylor
    branch: the gradient there is finite and JAX's."""
    rng = np.random.default_rng(8)
    params = _random_params(rng, 2)
    params["rot"][:] = 0.0
    params["pose"][:] = 0.0
    target = rng.uniform(0, 900, (2, 51, 2)).astype(np.float32)
    for v_j, g_j, v_p, g_p in _objective_pair(True, head, params, target):
        assert np.isfinite(g_p["rot"]).all() and np.abs(g_p["rot"]).max() > 0
        np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
        for k in g_j:
            np.testing.assert_allclose(g_p[k], g_j[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------

def test_lbfgs_stages_follow_jax_from_a_common_start(head):
    """Each stage of the fit, L-BFGS step by step from the same start: the
    rigid stage after 2 steps, then the full stage after 3 from JAX's rigid
    result (the JAX package's ``_lbfgs_solve`` vmapped against the port's
    batched solve)."""
    model, emb = head
    targets = np.concatenate([_targets(0, 4, True)[0], _targets(1, 4, False)[0]])
    rj, ej = jfit.restrict_to_landmarks(JM, JE)
    rp, ep = fit.restrict_to_landmarks(model, emb)
    t_p = torch.as_tensor(targets)

    def jax_stage1(target):
        base = {"trans": jnp.zeros(3), "rot": jnp.zeros(3), "pose": jnp.zeros(12),
                "shape": jnp.zeros(300), "exp": jnp.zeros(100)}
        base["scale"] = jfit.init_scale(rj, ej, base, target)
        p, loss = jfit._lbfgs_solve(
            lambda q: jfit._lmk_dist(rj, ej, {**base, **q}, target),
            {k: base[k] for k in ("scale", "trans", "rot")}, 2)
        return {**base, **p}, loss

    ref1, loss1 = jax.jit(jax.vmap(jax_stage1))(jnp.asarray(targets))
    base = fit.zero_params(rp, len(targets))
    base["scale"] = fit.init_scale(rp, ep, base, t_p)
    got1, got_loss1, _ = fit._solve(
        lambda q: fit._lmk_dist(rp, ep, {**base, **q}, t_p),
        {k: base[k] for k in ("scale", "trans", "rot")}, 2)
    np.testing.assert_allclose(got_loss1.numpy(), np.asarray(loss1), rtol=1e-5)
    for k in got1:
        np.testing.assert_allclose(got1[k].numpy(), np.asarray(ref1[k]),
                                   atol=1e-4 if k != "scale" else 1e-3, err_msg=k)

    def jax_stage2(target, p0):
        tz = p0["trans"][2]

        def loss2(q):
            m = dict(q, trans=jnp.concatenate([q["trans"][:2], tz[None]]))
            return jfit._lmk_dist(rj, ej, m, target) + jfit._regularizers(m)
        return jfit._lbfgs_solve(loss2, p0, 3)

    ref2, loss2 = jax.jit(jax.vmap(jax_stage2))(jnp.asarray(targets), ref1)
    start = {k: torch.as_tensor(np.asarray(v)) for k, v in ref1.items()}
    tz = start["trans"][:, 2:]

    def loss2_p(q):
        m = dict(q, trans=torch.cat([q["trans"][:, :2], tz], dim=1))
        return fit._lmk_dist(rp, ep, m, t_p) + fit._regularizers(m)

    got2, got_loss2, _ = fit._solve(loss2_p, start, 3)
    np.testing.assert_allclose(got_loss2.numpy(), np.asarray(loss2), rtol=1e-5)
    for k in got2:
        np.testing.assert_allclose(got2[k].numpy(), np.asarray(ref2[k]),
                                   atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def whole_fits(head):
    """32 frames (8 of a rigid pose, 24 with shape and expression) fitted at
    the default 30 + 60 steps by both packages."""
    model, emb = head
    t_rigid, gt_rigid = _targets(0, 8, True)
    targets = np.concatenate([t_rigid, _targets(1, 24, False)[0]])
    jp, jl = jfit.fit_batch(JM, JE, targets)
    pp, pl, evals = fit.fit_batch(model, emb, targets)
    return targets, gt_rigid, {k: np.asarray(v) for k, v in jp.items()}, \
        np.asarray(jl), pp, pl.numpy(), evals


def test_fit_batch_recovers_rigid_pose(head, whole_fits):
    """``tests/test_flame_fit.py:25-50`` on the port, beside JAX's fits of
    the same frames."""
    model, emb = head
    targets, gt, jp, jl, pp, pl, evals = whole_fits
    assert set(pp) == set(jp) == set(KEYS) | {"scale"}
    assert len(evals) == 2 and min(evals) >= 90
    proj = _reprojected(model, emb, pp)
    for losses, params in ((pl, {k: v.numpy() for k, v in pp.items()}), (jl, jp)):
        assert losses[:8].max() < 1e-3, losses[:8]
        np.testing.assert_allclose(params["rot"][:8], gt["rot"], atol=5e-3)
        np.testing.assert_allclose(params["trans"][:8, :2], gt["trans"][:, :2],
                                   atol=1e-3)
    for i in range(8):
        err = np.abs(proj[i] - targets[i]).max() / (np.ptp(targets[i]) + 1e-9)
        assert err < 0.02, (i, err)


def test_fit_batch_quality_matches_jax(head, whole_fits):
    model, emb = head
    targets, _, jp, jl, pp, pl, _ = whole_fits
    rms_p = _rms(_reprojected(model, emb, pp), targets)[8:]
    rms_j = _rms(np.asarray(jax.vmap(
        lambda p: p["scale"] * jfit.model_landmarks(JM, JE, p)[:, :2])(
            {k: jnp.asarray(v) for k, v in jp.items()})), targets)[8:]
    for q in (50, 95):
        a, b = np.percentile(rms_p, q), np.percentile(rms_j, q)
        assert abs(a - b) <= 0.15 * b, (q, a, b)
    assert np.isfinite(pl).all() and np.median(pl) <= 1.15 * np.median(jl)


def test_fit_batch_takes_init_and_a_row_does_not_depend_on_its_chunk(head):
    """A frame's fit is the same bits in a chunk of 2, 4 or 6. (A chunk of
    one frame may take BLAS's matrix-vector path for the blendshape
    products, another summation order.)"""
    model, emb = head
    targets, gt = _targets(3, 6, True)
    init = {"rot": gt["rot"] + 0.01, "pose": np.zeros((6, 12), np.float32),
            "shape": np.zeros((6, 100), np.float32),
            "exp": np.zeros((6, 50), np.float32)}
    steps = dict(stage1_steps=4, stage2_steps=6)
    whole, lw, _ = fit.fit_batch(model, emb, targets, init, **steps)
    for lo, hi in ((0, 4), (4, 6), (1, 3)):
        part, lp, _ = fit.fit_batch(model, emb, targets[lo:hi],
                                 {k: v[lo:hi] for k, v in init.items()}, **steps)
        for k in whole:
            assert torch.equal(part[k], whole[k][lo:hi]), (k, lo, hi)
        assert torch.equal(lp, lw[lo:hi])
    # the init was taken: four rigid steps from near the truth end near it
    np.testing.assert_allclose(whole["rot"].numpy(), gt["rot"], atol=2e-2)


def _write_openface_csv(part, targets):
    with open(part / "openface_25fps.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"c{i}" for i in range(436)])
        for i in range(targets.shape[0]):
            full = np.zeros((68, 2), np.float32)
            full[17:] = targets[i]
            full[17:, 1] = 1024.0 - full[17:, 1]   # un-flip for CSV storage
            w.writerow(["0", str(i), str(i / 25), "0.99", "1"] + ["0"] * 294
                       + [str(v) for v in full[:, 0]]
                       + [str(v) for v in full[:, 1]] + ["0"])


def test_fit_session_participant_writes_the_jax_layout(head, tmp_path):
    """CSV (+ a RingNet init file) -> ``flame_25fps.h5``: the JAX package's
    keys, shapes and dtypes; the values are the port's ``fit_batch`` of
    the same targets and init bit for bit, though fitted in ragged chunks
    of 4."""
    model, emb = head
    targets, gt = _targets(4, 6, True)
    for side in ("jax", "port"):
        part = tmp_path / side / "P1"
        part.mkdir(parents=True)
        _write_openface_csv(part, targets)
        with h5py.File(part / "ringnet_25fps.h5", "w") as f:
            f["flame_params/cam"] = np.zeros((6, 3), np.float32)
            f["flame_params/pose"] = np.concatenate(
                [gt["rot"], np.zeros((6, 3), np.float32)], axis=1)
            f["flame_params/shape"] = np.zeros((6, 100), np.float32)
            f["flame_params/expression"] = np.zeros((6, 50), np.float32)
    steps = dict(stage1_steps=3, stage2_steps=2)
    out_j = jfit.fit_session_participant(tmp_path / "jax" / "P1", 25, model=JM,
                                         emb=JE, batch_frames=4, **steps)
    out_p = fit.fit_session_participant(tmp_path / "port" / "P1", 25, model=model,
                                        emb=emb, batch_frames=4, device="cpu",
                                        **steps)
    np.testing.assert_array_equal(
        fit.openface_targets(list(csv.reader(open(tmp_path / "port" / "P1"
                                                  / "openface_25fps.csv")))[1:]),
        jfit.openface_targets(list(csv.reader(open(tmp_path / "jax" / "P1"
                                                   / "openface_25fps.csv")))[1:]))
    init = {"rot": gt["rot"], "pose": np.zeros((6, 12), np.float32),
            "shape": np.zeros((6, 100), np.float32),
            "exp": np.zeros((6, 50), np.float32)}
    direct, _, _ = fit.fit_batch(model, emb, fit.read_openface_targets(
        tmp_path / "port" / "P1", 25), init, **steps)
    with h5py.File(out_j) as fj, h5py.File(out_p) as fp:
        assert sorted(fp) == sorted(fj)
        for key in fj:
            assert fp[key].shape == fj[key].shape == (6,) + fj[key].shape[1:]
            assert fp[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(fp[key][()], direct[key[3:]].numpy())
        np.testing.assert_allclose(fp["tf_rot"][()], gt["rot"], atol=2e-2)


# ---------------------------------------------------------------------------
# RingNet-lite, mesh fitting, lipsync
# ---------------------------------------------------------------------------

def _shared_shape_targets(n=6):
    rng = np.random.default_rng(11)
    shape = np.zeros(300, np.float32)
    shape[:5] = rng.uniform(-1.2, 1.2, 5)
    gt = {"trans": rng.uniform(-0.03, 0.03, (n, 3)),
          "rot": rng.uniform(-0.4, 0.4, (n, 3)), "pose": np.zeros((n, 12)),
          "shape": np.tile(shape, (n, 1)), "exp": np.zeros((n, 100))}
    gt = {k: jnp.asarray(v, jnp.float32) for k, v in gt.items()}
    return (np.asarray(jax.vmap(lambda p: 750 * jfit.model_landmarks(JM, JE, p)[:, :2])(gt)),
            np.asarray(gt["rot"]))


def test_estimate_init_matches_jax(head):
    model, emb = head
    targets, _ = _shared_shape_targets()
    kw = dict(rigid_steps=2, shape_steps=5, shape_frames=6)
    ref = jring.estimate_init(JM, JE, targets, **kw)
    got = ringnet_lite.estimate_init(model, emb, targets, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4 if k != "scale" else 1e-3,
                                   err_msg=k)


def test_ringnet_lite_stage_writes_the_reference_layout(head, tmp_path):
    """``tests/test_flame_fit.py::test_ringnet_lite_stage`` on the port: the
    reference RingNet layout, one shared shape, rotations near the truth,
    idempotent, and an init that lowers the main fit's loss."""
    model, emb = head
    targets, true_rot = _shared_shape_targets()
    part = tmp_path / "P1"
    part.mkdir()
    _write_openface_csv(part, targets)
    out = ringnet_lite.extract_ringnet_lite(part, 25, model=model, emb=emb,
                                            shape_frames=6, device="cpu")
    assert out == part / "ringnet_25fps.h5"
    with h5py.File(out) as f:
        fp = f["flame_params"]
        assert {k: fp[k].shape for k in fp} == {
            "cam": (6, 3), "pose": (6, 6), "shape": (6, 100), "expression": (6, 50)}
        assert np.ptp(fp["shape"][()], axis=0).max() < 1e-6
        np.testing.assert_allclose(fp["pose"][:, :3], true_rot, atol=0.2)
        init = {"rot": fp["pose"][:, :3],
                "pose": np.pad(fp["pose"][:, 3:6], ((0, 0), (3, 6))),
                "shape": fp["shape"][()], "exp": fp["expression"][()]}
    mtime = out.stat().st_mtime_ns
    assert ringnet_lite.extract_ringnet_lite(part, 25, model=model, emb=emb,
                                             device="cpu") == out
    assert out.stat().st_mtime_ns == mtime
    steps = dict(stage1_steps=4, stage2_steps=8)
    _, with_init, _ = fit.fit_batch(model, emb, targets, init, **steps)
    _, zero, _ = fit.fit_batch(model, emb, targets, None, **steps)
    assert with_init.mean() < 0.9 * zero.mean(), (with_init, zero)


def _vertex_targets():
    rng = np.random.default_rng(7)
    n = 2
    exp = np.zeros((n, 100), np.float32)
    exp[:, :5] = rng.uniform(-1.5, 1.5, (n, 5))
    jaw = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    return np.asarray(jflame.flame_vertices(JM, jnp.zeros((n, 300)),
                                            jnp.asarray(exp), jnp.asarray(jaw),
                                            jnp.zeros((n, 3))))


@pytest.mark.parametrize("n_steps", [2, 150])
def test_fit_to_vertices_matches_jax(head, n_steps):
    model, _ = head
    targets = _vertex_targets()
    weights = {"expr": 1e-7, "jaw": 1e-7, "neck": 1e-7, "shape": 1e-7}
    ref, ref_loss = jfit.fit_to_vertices(JM, targets, n_steps=n_steps,
                                         weights=weights)
    got, loss = fit.fit_to_vertices(model, targets, n_steps=n_steps,
                                    weights=weights, batch_frames=1)
    assert set(got) == set(ref)
    if n_steps == 2:
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-6, err_msg=k)
    else:   # tests/test_flame_fit.py:311-333's recovery limits, on both
        assert max(loss.max().item(), np.asarray(ref_loss).max()) < 1e-4
        with torch.no_grad():
            recon = pflame.flame_vertices(model, got["shape"], got["exp"],
                                          got["jaw"], got["neck"])
        recon = (recon + got["trans"][:, None]).numpy()
        assert np.abs(recon - targets).max() < 5e-3


def _speech_like(fs=16000, duration=2.0):
    t = np.arange(int(duration * fs)) / fs
    env = np.zeros_like(t)
    third = len(t) // 3
    env[third:2 * third] = 1.0
    return (np.sin(2 * np.pi * 150 * t) * 0.5 * env).astype(np.float32)


def test_envelope_lipsync_matches_jax(head):
    model, _ = head
    audio, template = _speech_like(), np.asarray(JM.v_template) + 0.01
    ref_model, got_model = jlip.EnvelopeLipsync(JM), lipsync.EnvelopeLipsync(model)
    ref_p = ref_model.params_for_audio(audio, 16000)
    got_p = got_model.params_for_audio(audio, 16000)
    for k in ref_p:
        np.testing.assert_array_equal(got_p[k], ref_p[k])
    ref = ref_model(audio, 16000, template)
    got = got_model(audio, 16000, template)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (120, 160, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_extract_voca_and_flame_params_match_jax(head, tmp_path):
    from lets_face_it_tpu.features.audio_io import write_wav
    from lets_face_it_tpu_torch.render.flame import write_ply

    model, _ = head
    for side in ("jax", "port"):
        part = tmp_path / side / "S1" / "P1"
        part.mkdir(parents=True)
        write_ply(part / "neutral_mesh.ply", np.asarray(JM.v_template), JM.faces)
        write_wav(part / "audio.wav", _speech_like(), 16000)
    lookup = {"P1": 50}
    (ref_file,) = jlip.extract_voca(tmp_path / "jax", 25,
                                    model=jlip.EnvelopeLipsync(JM),
                                    nb_frames_lookup=lookup)
    (got_file,) = lipsync.extract_voca(tmp_path / "port", 25,
                                       model=lipsync.EnvelopeLipsync(model),
                                       nb_frames_lookup=lookup)
    np.testing.assert_allclose(np.load(got_file), np.load(ref_file), atol=1e-5)
    assert lipsync.extract_voca(tmp_path / "port", 25,
                                model=lipsync.EnvelopeLipsync(model),
                                nb_frames_lookup=lookup) == []

    meshes = np.load(ref_file)[:4]
    ref = jlip.voca_to_flame_params(meshes, JM, tmp_path / "jax_out", n_steps=2)
    got = lipsync.voca_to_flame_params(meshes, model, tmp_path / "port_out",
                                       n_steps=2)
    assert [f.name for f in got] == [f.name for f in ref]
    for a, b in zip(got, ref):
        da, db = (np.load(f, allow_pickle=True).item() for f in (a, b))
        assert sorted(da) == sorted(db)
        for k in db:
            assert da[k].shape == db[k].shape and da[k].dtype == db[k].dtype
            np.testing.assert_allclose(da[k], db[k], atol=1e-6, err_msg=k)

