"""The port's render layer against the JAX package's on the CPU: the FLAME
decoder (``render/flame.py``), the native rasterizer's binding, the video
stages and the HTTP render service with the port's render client.

Inputs are made with numpy from a seed and handed to both sides. Tolerance of
the decoder: atol 1e-5 on vertices of |x| up to about 0.7 (float32 products
over 400 components and a 4x4 transform chain per vertex in another
summation order; read about 2e-7). The synthetic head, the loaded models and
the rasterized images must be equal, bit for bit."""

import json
import pickle
import sys
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.render import flame as jflame
from lets_face_it_tpu.render import video as jvideo
from lets_face_it_tpu.render.rasterizer import Rasterizer as JaxRasterizer
from lets_face_it_tpu.render.server import RenderService as JaxRenderService
from lets_face_it_tpu.render.texture import (cylindrical_uv_layout,
                                             procedural_skin_texture)
from lets_face_it_tpu_torch.render import flame as pflame
from lets_face_it_tpu_torch.render import video as pvideo
from lets_face_it_tpu_torch.render.rasterizer import Rasterizer
from lets_face_it_tpu_torch.render.server import (RenderService, byteify,
                                                  make_handler)

from test_torch_port_common import port_hp, train_hp

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VERT_ATOL = 1e-5


def _models(n_vertices):
    return (jflame.synthetic_flame_model(n_vertices),
            pflame.synthetic_flame_model(n_vertices, device="cpu"))


def _params(n, seed=1, scale=0.3):
    """shape, expression, jaw, neck, eyes, global_rot as float32 arrays."""
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((n, d))).astype(np.float32)
            for d in (300, 100, 3, 3, 6, 3)]


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# FLAME decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_vertices", [96, 5023])
def test_synthetic_flame_model_equals_jax(n_vertices):
    """The same numpy draws in the same order: every tensor bit for bit."""
    jm, pm = _models(n_vertices)
    for name in pflame.FlameModel._fields[:-1]:
        got = getattr(pm, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert pm.faces.dtype == np.int32
    np.testing.assert_array_equal(pm.faces, jm.faces)


@pytest.mark.parametrize("case", ["zero", "tiny", "random"])
def test_rodrigues_values_and_gradient_match_jax(case):
    """Values and the gradient of a weighted sum of the matrices against
    ``jax.grad``, at an exact zero rotation (the Taylor branch on safe
    inputs keeps it finite), below the branch's threshold and at random
    rotations."""
    rng = np.random.default_rng(2)
    rvec = {"zero": np.zeros((4, 3)),
            "tiny": 1e-7 * rng.standard_normal((4, 3)),
            "random": rng.standard_normal((4, 3))}[case].astype(np.float32)
    weights = rng.standard_normal((4, 3, 3)).astype(np.float32)

    want = np.asarray(jflame.rodrigues(jnp.asarray(rvec)))
    want_grad = np.asarray(jax.grad(lambda r: jnp.sum(
        jflame.rodrigues(r) * weights))(jnp.asarray(rvec)))
    r = _t(rvec).requires_grad_(True)
    got = pflame.rodrigues(r)
    (got * _t(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)
    assert torch.isfinite(r.grad).all()
    np.testing.assert_allclose(r.grad.numpy(), want_grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_vertices", [128, 5023])
@pytest.mark.parametrize("fn", ["flame_vertices", "pose_and_skin", "get_vertices"])
def test_decoder_matches_jax(fn, n_vertices):
    """The decoder's three entry points on the same arrays: vertices within
    VERT_ATOL of the JAX package's (highest matmul precision)."""
    jm, pm = _models(n_vertices)
    n = 5
    shape, expression, jaw, neck, eyes, global_rot = _params(n)
    if fn == "flame_vertices":
        want = jflame.flame_vertices(jm, *map(jnp.asarray, _params(n)))
        got = pflame.flame_vertices(pm, *map(_t, _params(n)))
    elif fn == "pose_and_skin":
        rng = np.random.default_rng(3)
        v_shaped = (np.asarray(jm.v_template)
                    + 0.05 * rng.standard_normal((n, n_vertices, 3))).astype(np.float32)
        joints = np.einsum("jv,nvc->njc", np.asarray(jm.j_regressor, np.float64),
                           v_shaped).astype(np.float32)
        args = (v_shaped, joints, jaw, neck, eyes, global_rot)
        want = jflame.pose_and_skin(jm.posedirs, jm.lbs_weights,
                                    *map(jnp.asarray, args))
        got = pflame.pose_and_skin(pm.posedirs, pm.lbs_weights, *map(_t, args))
    else:
        # pose [N, 12]: global rotation (zeroed by the contract) then jaw;
        # 50 expression components, as the render service receives them
        pose = np.concatenate([eyes, eyes], axis=1)
        args = (expression[:, :50], pose, global_rot)
        want = jflame.get_vertices(jm, *map(jnp.asarray, args),
                                   shape=jnp.asarray(shape))
        got = pflame.get_vertices(pm, *map(_t, args), shape=_t(shape))
    assert got.shape == (n, n_vertices, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VERT_ATOL, rtol=0)


def test_neutral_mesh_and_drawn_shape():
    """The neutral mesh equals the JAX package's; without ``shape``
    ``get_vertices`` draws one 100-D shape from its generator (another
    stream than JAX's ``PRNGKey(0)``), held over the sequence, and the same
    seed gives the same draw."""
    jm, pm = _models(96)
    np.testing.assert_allclose(pflame.neutral_mesh_vertices(pm).numpy(),
                               np.asarray(jflame.neutral_mesh_vertices(jm)),
                               atol=VERT_ATOL, rtol=0)
    n = 3
    zeros = torch.zeros
    a = pflame.get_vertices(pm, zeros(n, 50), zeros(n, 12), zeros(n, 3),
                            generator=torch.Generator().manual_seed(5))
    b = pflame.get_vertices(pm, zeros(n, 50), zeros(n, 12), zeros(n, 3),
                            generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(a[0], a[2], atol=0, rtol=0)
    default = pflame.get_vertices(pm, zeros(n, 50), zeros(n, 12), zeros(n, 3))
    torch.testing.assert_close(default, pflame.get_vertices(
        pm, zeros(n, 50), zeros(n, 12), zeros(n, 3),
        generator=torch.Generator().manual_seed(0)), atol=0, rtol=0)
    with pytest.raises(ValueError, match="exceeds"):
        pflame.flame_vertices(pm, zeros(1, 301), zeros(1, 50), zeros(1, 3),
                              zeros(1, 3))


# ---------------------------------------------------------------------------
# Loading: .npz, the chumpy pickle, the JAX package's arrays, PLY
# ---------------------------------------------------------------------------

def _flame_fields(n_vertices=64, seed=4):
    """A FLAME 2019-layout payload (field names of the official pickle)."""
    jm = jflame.synthetic_flame_model(n_vertices, seed=seed)
    return {"v_template": np.asarray(jm.v_template, np.float64) * 1.5,
            "shapedirs": np.asarray(jm.shapedirs, np.float64),
            "posedirs": np.asarray(jm.posedirs, np.float64),
            "J_regressor": np.asarray(jm.j_regressor, np.float64),
            "weights": np.asarray(jm.lbs_weights, np.float64),
            "f": jm.faces.astype(np.uint32)}


class _Ch:
    """Pickles as chumpy's ``Ch`` does: the array in its state's ``x``."""

    def __init__(self, x):
        self.x = x

    def __getstate__(self):
        return {"x": self.x}


def _write_chumpy_pickle(path, fields, monkeypatch):
    """The official release's layout: chumpy-wrapped arrays, a scipy sparse
    J_regressor and posedirs stored [V*3, 36]. A stand-in ``chumpy.ch``
    module is registered only for the dump."""
    from scipy.sparse import csc_matrix

    module = types.ModuleType("chumpy.ch")
    _Ch.__module__, _Ch.__qualname__ = "chumpy.ch", "Ch"
    module.Ch = _Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", module)
    payload = dict(fields)
    for key in ("v_template", "shapedirs", "weights"):
        payload[key] = _Ch(fields[key])
    payload["posedirs"] = _Ch(fields["posedirs"].reshape(-1, 36))
    payload["J_regressor"] = csc_matrix(fields["J_regressor"])
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=2)
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    monkeypatch.delitem(sys.modules, "chumpy")


@pytest.mark.parametrize("kind", ["npz", "chumpy_pickle"])
def test_load_flame_equals_jax(kind, tmp_path, monkeypatch):
    fields = _flame_fields()
    if kind == "npz":
        path = tmp_path / "flame.npz"
        np.savez(path, **fields)
    else:
        path = tmp_path / "generic_model.pkl"
        _write_chumpy_pickle(path, fields, monkeypatch)
    got = pflame.load_flame(path, device="cpu")
    want = jflame.load_flame(path)
    for name in pflame.FlameModel._fields[:-1]:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.posedirs.shape == (64, 3, 36) and got.faces.dtype == np.int32


def test_flame_model_from_jax_arrays_and_to():
    jm = jflame.synthetic_flame_model(80, seed=7)
    pm = pflame.flame_model_from_arrays(
        {k: np.asarray(v) for k, v in jm._asdict().items()}, "cpu")
    for name in pflame.FlameModel._fields[:-1]:
        np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    moved = pm.to("cpu")
    assert moved.device == torch.device("cpu") and moved.faces is pm.faces


def test_ply_round_trip_and_file_equals_jax(tmp_path):
    jm, pm = _models(64)
    verts = pflame.neutral_mesh_vertices(pm)
    pflame.write_ply(tmp_path / "port.ply", verts, pm.faces)
    jflame.write_ply(tmp_path / "jax.ply", verts.numpy(), jm.faces)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    v, f = pflame.read_ply(tmp_path / "port.ply")
    np.testing.assert_array_equal(v, verts.numpy())
    np.testing.assert_array_equal(f, pm.faces)


# ---------------------------------------------------------------------------
# Rasterizer and video stages
# ---------------------------------------------------------------------------

def _sequence(n_vertices=5023, n=2, seed=6):
    _, pm = _models(n_vertices)
    rng = np.random.default_rng(seed)
    return pm, pflame.get_vertices(
        pm, _t(0.5 * rng.standard_normal((n, 50)).astype(np.float32)),
        _t(0.1 * rng.standard_normal((n, 12)).astype(np.float32)),
        _t(0.1 * rng.standard_normal((n, 3)).astype(np.float32)),
        shape=torch.zeros(n, 300)).numpy()


@pytest.mark.parametrize("textured", [False, True])
def test_rasterizer_images_equal_jax(textured):
    """Two heads of 5,023 vertices at 512x256: the port's binding over its
    own build of native/rasterizer.cpp draws the JAX package's images, byte
    for byte."""
    pm, verts = _sequence()
    w, h = 512, 256
    cam = dict(width=w, height=h, x=w // 2, y=100, z=-1, f=(1188.74, 1188.74))
    left, right = verts.copy(), verts.copy()
    left[..., 0] -= 0.2
    right[..., 0] += 0.2
    if textured:
        ones = np.ones((verts.shape[1], 3), np.float32)
        uv = cylindrical_uv_layout(verts[0], pm.faces)
        tex = [procedural_skin_texture("white", 64, seed=0),
               procedural_skin_texture("black", 96, seed=1)]
        meshes = [(left, pm.faces, ones), (right, pm.faces, ones)]
        kwargs = dict(uvs=[uv, uv], textures=tex)
    else:
        colors = np.tile(np.float32([[0.95, 0.78, 0.66]]), (verts.shape[1], 1))
        meshes = [(left, pm.faces, colors), (right, pm.faces, 0.5 * colors)]
        kwargs = {}
    got = Rasterizer(**cam).render(meshes, **kwargs)
    want = JaxRasterizer(**cam).render(meshes, **kwargs)
    assert got.shape == (2, h, w, 3)
    assert (got != 255).any(axis=-1).mean() > 0.3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("textured", [False, True])
def test_double_face_video_matches_jax(textured, tmp_path, monkeypatch):
    """``render_double_face_video`` on the CPU, flat and textured: the mp4 is
    written with one frame per vertex frame, and the images of the raster
    stage equal the JAX package's (caught from its Rasterizer)."""
    import cv2

    pm, verts = _sequence(n_vertices=512, n=3)
    jax_images = []
    original = JaxRasterizer.render

    def recording(self, *args, **kwargs):
        jax_images.append(original(self, *args, **kwargs))
        return jax_images[-1]

    monkeypatch.setattr(JaxRasterizer, "render", recording)
    kw = dict(skin_color_v1="white", skin_color_v2="black", width=512,
              height=512, textured=textured)
    jvideo.render_double_face_video(tmp_path / "jax.mp4", verts, verts,
                                    pm.faces, fps=25, **kw)
    out = pvideo.render_double_face_video(tmp_path / "port.mp4", _t(verts),
                                          verts, pm.faces, fps=25, **kw)
    assert out == tmp_path / "port.mp4"
    frames = pvideo.render_double_face_frames(verts, verts, pm.faces, **kw)
    assert frames.shape == (3, 512, 512, 3) and (frames != 255).any()
    np.testing.assert_array_equal(frames, jax_images[0])
    cap = cv2.VideoCapture(str(out))
    try:
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    finally:
        cap.release()


# ---------------------------------------------------------------------------
# HTTP render service
# ---------------------------------------------------------------------------

def _face(t, seed):
    rng = np.random.default_rng(seed)
    return {"expression": byteify((0.3 * rng.standard_normal((t, 50))).astype(np.float32)),
            "pose": byteify((0.1 * rng.standard_normal((t, 12))).astype(np.float32)),
            "shape": byteify((0.5 * rng.standard_normal((t, 300))).astype(np.float32)),
            "rotation": byteify((0.1 * rng.standard_normal((t, 3))).astype(np.float32))}


@pytest.fixture
def port_server(tmp_path):
    service = RenderService(flame_model=pflame.synthetic_flame_model(64, device="cpu"),
                            video_dir=tmp_path / "videos", width=128, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_service_vertices_match_jax_service(tmp_path):
    """A request's faces decoded by the port's service (tensors on its
    device) and by the JAX package's, on the same head and blobs."""
    jm = jflame.synthetic_flame_model(200)
    pm = pflame.flame_model_from_arrays(
        {k: np.asarray(v) for k, v in jm._asdict().items()}, "cpu")
    port = RenderService(pm, tmp_path, device="cpu")
    ref = JaxRenderService(jm, tmp_path)
    face = _face(6, seed=8)
    got = port.get_vertices(face)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref.get_vertices(face),
                               atol=VERT_ATOL, rtol=0)


def test_http_round_trip(port_server):
    """POST /render in the reference's byte protocol, then GET the video;
    unknown paths and videos answer 404."""
    service, url = port_server
    payload = json.dumps({"seqs": [_face(4, 1), _face(4, 2)], "fps": 25,
                          "file_name": "test.mp4"}).encode()
    req = urllib.request.Request(f"{url}/render", data=payload,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    video_path = out["url"].split("/video/", 1)[1]
    assert (service.video_dir / "test.mp4").exists()
    with urllib.request.urlopen(f"{url}/video/{video_path}", timeout=30) as resp:
        assert resp.headers["Content-Type"] == "video/mp4"
        assert len(resp.read()) > 500
    for bad in ("/video/none.mp4", "/other"):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}{bad}", timeout=30)
        assert err.value.code == 404


def test_port_render_client_against_port_server(port_server):
    """The trainer's render client posts to the port's own service and gets
    the video's URL back (on_rendered)."""
    from lets_face_it_tpu_torch.train.render_client import RenderClient

    service, url = port_server
    hp = port_hp(train_hp())
    hp.dataset_root = str(service.video_dir / "no_store")
    client = RenderClient(url, hp, timeout=120)
    seen, fired = {}, threading.Event()
    client.on_rendered = lambda step, u: (seen.update(step=step, url=u), fired.set())
    seq = np.random.default_rng(0).standard_normal((1, 5, 16)).astype(np.float32)
    client(seq, seq, step=9).join(timeout=120)
    assert fired.wait(timeout=5), "on_rendered never fired"
    assert seen["step"] == 9 and "/video/" in seen["url"]
    assert seen["url"].endswith("/val_9.mp4")
    assert (service.video_dir / "val_9.mp4").stat().st_size > 500
