"""Static model specifications derived from hparams (the port's copy of
``lets_face_it_tpu/model/spec.py``, without the JAX-only ``remat`` and
``step_unroll`` fields).

These frozen dataclasses are the static half of the model; the parameters
live in ``model/seqglow.py::SeqGlow``. Dimensional semantics follow the
reference glow_pytorch ``models.py``:
  * rnn/lstm encoder output dim = 2 * hidden (final hidden duplicated — the
    reference concatenates ``seq[:, -1]`` with ``h_state[0]``, which for a
    single-layer unidirectional RNN are the same tensor, models.py:64,69)
  * mlp dim = hidden_dim; none dim = input * history
  * cnn dim = hidden_dim * history (the reference's ``self.dim`` formula at
    models.py:48 is inconsistent with its own forward and never exercised by
    shipped configs; we use the correct output size)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from lets_face_it_tpu_torch.hparams import HParams, longest_history


@dataclass(frozen=True)
class EncSpec:
    enc: str            # "rnn" | "lstm" | "mlp" | "cnn" | "none"
    input_dim: int
    history: int
    hidden_dim: int
    dropout: float
    kernel_size: int
    out_dim: int

    @staticmethod
    def build(input_dim: int, params: dict) -> "EncSpec":
        enc = params["enc"]
        history = params["history"]
        hidden = params.get("hidden_dim", 0)
        kernel = params.get("kernel_size", 3)
        if enc in ("rnn", "lstm"):
            out = hidden * 2
        elif enc == "mlp":
            out = hidden
        elif enc == "cnn":
            out = hidden * (history + 2 * (kernel // 2) - kernel + 1)
        elif enc == "none":
            out = input_dim * history
        else:
            raise NotImplementedError(f"encoder type {enc!r}")
        return EncSpec(enc, input_dim, history, hidden,
                       float(params.get("dropout", 0.0)), kernel, out)


@dataclass(frozen=True)
class CondSpec:
    p1_face: EncSpec
    p2_face: Optional[EncSpec]
    p1_speech: Optional[EncSpec]
    p2_speech: Optional[EncSpec]
    use_frame_nb: bool
    cond_dim: int
    feature_dim: int      # FeatureEncoder total output dim
    longest_history: int

    @staticmethod
    def build(conditioning: dict, data: dict) -> "CondSpec":
        speech_dim = data["speech_dim"]
        # p1_face.dim == 0 disables own-face conditioning entirely (the
        # reference's no_face ablation); the flow's channel count comes from
        # the Data dims, not from here (see FlowSpec.build).
        p1_face = EncSpec.build(conditioning["p1_face"]["dim"], conditioning["p1_face"])
        if p1_face.input_dim == 0:
            p1_face = EncSpec(p1_face.enc, 0, p1_face.history, p1_face.hidden_dim,
                              p1_face.dropout, p1_face.kernel_size, 0)
        total = p1_face.out_dim

        def optional(name: str, dim: int) -> Optional[EncSpec]:
            nonlocal total
            if conditioning[name]["history"]:
                spec = EncSpec.build(dim, conditioning[name])
                total += spec.out_dim
                return spec
            return None

        p2_face = optional("p2_face", conditioning["p2_face"].get("dim", p1_face.input_dim))
        p1_speech = optional("p1_speech", speech_dim)
        p2_speech = optional("p2_speech", speech_dim)
        use_frame_nb = bool(conditioning.get("use_frame_nb", False))
        if use_frame_nb:
            total += 1
        return CondSpec(
            p1_face, p2_face, p1_speech, p2_speech, use_frame_nb,
            conditioning["cond_dim"], total, longest_history(conditioning),
        )


@dataclass(frozen=True)
class FlowSpec:
    channels: int          # x dim (56 in final model)
    hidden_channels: int   # coupling RNN hidden
    n_steps: int           # K * L flow steps
    permutation: str       # "invconv" | "shuffle" | "reverse"
    coupling: str          # "affine" | "additive"
    rnn_type: str          # "gru" | "lstm"
    lu_decomposed: bool
    scale_eps: float
    actnorm_scale: float
    cond: CondSpec

    @property
    def z1_dim(self) -> int:
        return self.channels // 2

    @property
    def coupling_out_dim(self) -> int:
        c = self.channels
        if self.coupling == "additive":
            return c - c // 2
        return c if c % 2 == 0 else c + 1

    @staticmethod
    def build(hp: HParams) -> "FlowSpec":
        cond = CondSpec.build(hp.Conditioning, hp.Data)
        g = hp.Glow
        x_dim = hp.Data["expression_dim"] + hp.Data["jaw_dim"] + hp.Data["neck_dim"]
        return FlowSpec(
            channels=x_dim,
            hidden_channels=g["hidden_channels"],
            n_steps=g["K"] * g["L"],
            permutation=g["flow_permutation"],
            coupling=g["flow_coupling"],
            rnn_type=g["rnn_type"],
            lu_decomposed=bool(g.get("LU_decomposed", True)),
            scale_eps=float(g.get("scale_eps", 1e-6)),
            actnorm_scale=float(g.get("actnorm_scale", 1.0)),
            cond=cond,
        )
