"""The port's serving slice as a whole against the JAX package, with the JAX
random streams replayed and injected as latents (torch and JAX draw different
numbers from the same seed): ``sequence_sample``, ``Generator.generate`` and
``StreamingGenerator``. Tolerance: atol 2e-4, rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.sample.generate import Generator as JaxGenerator
from lets_face_it_tpu.sample.streaming import StreamingGenerator as JaxStreaming
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.sample.generate import Generator
from lets_face_it_tpu_torch.sample.streaming import (StreamingGenerator,
                                                     run_paced_session)

from conftest import random_batch
from test_torch_port_common import (assert_close, jax_params, port_hp,
                                    port_model, specs, tiny_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("case, path", [
    ("own_face", "sequence"), ("no_face", "sequence"),
    ("own_face_rnn", "frame"), ("lstm_coupling", "plain")])
def test_sequence_sample_matches_jax(case, path):
    """One case per sampling path: the sequence kernel's twin, the per-frame
    kernel's twin (a recurrent own-face encoder) and the plain flow (an LSTM
    coupling, outside both kernels' envelope)."""
    hp = tiny_hp(0 if case == "no_face" else 12)
    if case == "own_face_rnn":
        hp.Conditioning["p1_face"]["enc"] = "rnn"
    if case == "lstm_coupling":
        hp.Glow["rnn_type"] = "lstm"
    spec, pspec = specs(hp)
    assert pseqglow.sampling_path(pspec) == path
    params = jax_params(spec, seed=1)
    model = port_model(params, pspec)
    seq_len, b = 12, 3
    data = random_batch(hp, batch_size=b, seq_len=seq_len, seed=2)
    rng = np.random.default_rng(3)
    data["p1_face"] = rng.standard_normal((b, seq_len, spec.channels)).astype(np.float32)
    data["p2_face"] = rng.standard_normal((b, seq_len, spec.channels)).astype(np.float32)
    n = seq_len - spec.cond.longest_history
    z_seq = rng.standard_normal((n, b, spec.channels)).astype(np.float32)
    want = jseqglow.sequence_sample(spec, params, data, seq_len,
                                    rng=jax.random.PRNGKey(0), z_seq=z_seq)
    got = pseqglow.sequence_sample(pspec, model, {k: t(v) for k, v in data.items()},
                                   seq_len, z_seq=t(z_seq))
    assert got.shape == (b, n, spec.channels)
    assert_close(got, want)


def _frames(hp, n, seed):
    return np.random.default_rng(seed).standard_normal((n, 273)).astype(np.float32)


def test_generator_generate_matches_jax(tmp_path):
    hp = tiny_hp()
    hp.dataset_root = str(tmp_path)
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=4)
    frames = _frames(hp, 14, seed=5)
    seed, eps = 3, 0.7
    want = JaxGenerator(hp, params).generate(frames, eps=eps, seed=seed)
    n = frames.shape[0] - spec.cond.longest_history
    z = jax.random.normal(jax.random.PRNGKey(seed), (n, 1, spec.channels)) * eps
    gen = Generator(port_hp(hp), port_model(params, pspec), device="cpu")
    got = gen.generate(frames, eps=eps, seed=seed, z=t(z))
    assert got.shape == want.shape == (1, n, 106)
    assert_close(got, want)
    # without z the latents come from the generator's own seeded stream
    again = gen.generate(frames, eps=eps, seed=seed)
    np.testing.assert_array_equal(again, gen.generate(frames, eps=eps, seed=seed))


def _jax_stream_latents(seed, count, b, c, eps):
    """JAX StreamingGenerator's per-frame draws (streaming.py:102-103)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(count):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(sub, (b, c)) * jnp.float32(eps)))
    return np.stack(out)                                  # [count, B, C]


def _stream_inputs(hp, spec, n, b, seed):
    rng = np.random.default_rng(seed)
    s = hp.Data["speech_dim"]
    return [{"p2_face": rng.standard_normal((b, spec.channels)).astype(np.float32),
             "p1_speech": rng.standard_normal((b, s)).astype(np.float32),
             "p2_speech": rng.standard_normal((b, s)).astype(np.float32)}
            for _ in range(n)]


def test_streaming_push_and_push_many_match_jax():
    hp = tiny_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=6)
    b, seed, eps = 2, 11, 0.8
    frames = _stream_inputs(hp, spec, 9, b, seed=7)
    jgen = JaxStreaming(spec, params, batch_size=b, eps_std=eps, seed=seed,
                        use_fused=False)
    want = [np.asarray(jgen.push(**f)) for f in frames[:5]]
    many = {k: np.stack([f[k] for f in frames[5:]], 1) for k in frames[0]}
    want.extend(np.moveaxis(np.asarray(jgen.push_many(**many)), 1, 0))
    zs = _jax_stream_latents(seed, 9, b, spec.channels, eps)

    gen = StreamingGenerator(pspec, port_model(params, pspec), batch_size=b,
                             eps_std=eps, seed=seed, device="cpu")
    got = [gen.push(**f, z=t(zs[i])) for i, f in enumerate(frames[:5])]
    got.extend(gen.push_many(**many, z=t(zs[5:]).transpose(0, 1)).transpose(0, 1))
    for g, w in zip(got, want):
        assert_close(g, w)
    with pytest.raises(ValueError, match="frames"):
        bad = dict(many)
        bad["p1_speech"] = many["p1_speech"][:, :-1]
        gen.push_many(**bad)


def test_push_staged_and_reset_match_pushes():
    """The staged stream with a device-resident cursor, under any partition,
    gives what single pushes give on the same random stream; reset restarts
    the sequence's own-face history and GRU states."""
    hp = tiny_hp()
    spec, pspec = specs(hp)
    model = port_model(jax_params(spec, seed=8), pspec)
    frames = _stream_inputs(hp, spec, 5, 2, seed=9)
    gen_a = StreamingGenerator(pspec, model, batch_size=2, seed=3, device="cpu")
    singles = torch.stack([gen_a.push(**f) for f in frames], 1)
    gen_b = StreamingGenerator(pspec, model, batch_size=2, seed=3, device="cpu")
    staged = gen_b.stage_session(frames)
    out1, cur = gen_b.push_staged(staged, 0, 3)
    out2, cur = gen_b.push_staged(staged, cur, 2)
    assert int(cur) == 5
    assert_close(torch.cat([out1, out2], 1), singles.numpy(), atol=1e-6, rtol=0)
    gen_b.reset()     # a new sequence: own-face history and GRU states zeroed
    assert not gen_b.face_hist.any() and not gen_b.states.any()


def test_paced_session_values_independent_of_pacing():
    hp = tiny_hp()
    spec, pspec = specs(hp)
    model = port_model(jax_params(spec, seed=10), pspec)
    frames = _stream_inputs(hp, spec, 20, 1, seed=12)
    gen_a = StreamingGenerator(pspec, model, seed=5, device="cpu")
    plain = torch.stack([gen_a.push(**f) for f in frames], 1).numpy()
    gen_b = StreamingGenerator(pspec, model, seed=5, device="cpu")
    report = run_paced_session(gen_b, frames, depth=2, fps=1000.0,
                               precompile=False)
    assert report.frames.shape == (1, 20, spec.channels)
    np.testing.assert_allclose(report.frames, plain, atol=1e-6)
    assert 1 <= report.max_dispatch <= 8 and report.min_depth >= 0
    assert gen_b.catchup_sizes(6) == [1, 2, 4]
