"""The port's parameter counts and input-shape table against the reference's.

For every architecture of both registries, full size and smoke:
``param_count``, ``active_param_count`` and their ``_attn_params`` /
``_mlp_params`` / ``_ssm_params`` terms are equal (exact integers), and so
is the list of applicable shape cells. The shape table itself
(``LM_SHAPES``, ``SHAPES_BY_NAME``, ``LONG_CONTEXT_ARCHS``, ``get_shape``,
``all_configs``) is the reference's. ``tests/test_arch_smoke.py:67``'s
bounds run on the port.

``param_count`` is an analytic count; the parameter tree ``init``
materialises differs from it for five architectures, each difference pinned
here as a formula in the config's fields (the trees are counted under
``FakeTensorMode``, which allocates nothing). ``chip_smoke.py`` takes its
parameter constants from ``param_count`` where the two agree and keeps the
tree's count where they do not; its shape constants come from the table.
"""
import importlib.util
from pathlib import Path

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.models.model import get_model
from repro_torch.training.optimizer import named_leaves

ROOT = Path(__file__).resolve().parents[1]


def _count_terms(cfg):
    return (cfg.param_count(), cfg.active_param_count(), cfg._attn_params(),
            cfg._mlp_params(), cfg._ssm_params())


def test_registries_and_shape_table_match():
    assert set(tcfg.ARCH_NAMES) == set(jcfg.ARCH_NAMES)
    assert tcfg.LONG_CONTEXT_ARCHS == jcfg.LONG_CONTEXT_ARCHS
    assert [(s.name, s.seq_len, s.global_batch, s.kind, s.is_train, s.is_decode)
            for s in tcfg.LM_SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind, s.is_train, s.is_decode)
         for s in jcfg.LM_SHAPES]
    assert list(tcfg.SHAPES_BY_NAME) == list(jcfg.SHAPES_BY_NAME)
    for name in jcfg.SHAPES_BY_NAME:
        assert tcfg.get_shape(name).seq_len == jcfg.get_shape(name).seq_len
    assert list(tcfg.all_configs()) == list(tcfg.ARCH_NAMES)
    with pytest.raises(KeyError):
        tcfg.get_shape("train_8k")


@pytest.mark.parametrize("arch", jcfg.ARCH_NAMES)
def test_param_counts_equal_reference(arch):
    for smoke in (False, True):
        got, want = tcfg.get_config(arch), jcfg.get_config(arch)
        if smoke:
            got, want = got.smoke(), want.smoke()
        assert _count_terms(got) == _count_terms(want), (arch, smoke)


@pytest.mark.parametrize("arch", jcfg.ARCH_NAMES)
def test_applicable_shapes_equal_reference(arch):
    got = [s.name for s in tcfg.applicable_shapes(tcfg.get_config(arch))]
    assert got == [s.name for s in jcfg.applicable_shapes(jcfg.get_config(arch))]
    assert ("long_500k" in got) == (arch in tcfg.LONG_CONTEXT_ARCHS)


def test_param_counts_match_analytic():
    """tests/test_arch_smoke.py:67 on the port."""
    expect = {
        "yi-6b": (5.5e9, 7.5e9),
        "qwen2.5-32b": (30e9, 36e9),
        "mamba2-130m": (0.10e9, 0.16e9),
        "moonshot-v1-16b-a3b": (24e9, 32e9),
    }
    for arch, (lo, hi) in expect.items():
        n = tcfg.get_config(arch).param_count()
        assert lo < n < hi, f"{arch}: {n / 1e9:.2f}B outside [{lo / 1e9},{hi / 1e9}]"
    moonshot = tcfg.get_config("moonshot-v1-16b-a3b")
    assert moonshot.active_param_count() < 0.3 * moonshot.param_count()


def _tree_minus_analytic(cfg):
    """What the materialised tree holds beyond ``param_count``, by arch."""
    L, d = cfg.num_layers, cfg.d_model
    conv_bias = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    return {
        # q and k RMSNorm scales
        "chameleon-34b": L * 2 * cfg.d_head,
        # the expert stack padded from 60 to 64 experts
        "qwen2-moe-a2.7b": L * (cfg.expert_pad_to - cfg.num_experts) * 3 * d * cfg.moe_d_ff,
        # the depthwise convolution's bias
        "zamba2-1.2b": L * conv_bias,
        "mamba2-130m": L * conv_bias,
        # the decoder's head is the embedding (no separate head); LayerNorm
        # biases (2 an encoder layer, 3 a decoder layer, the final norm's)
        # and the encoder's final norm
        "whisper-tiny": -cfg.vocab_size * d
        + (2 * cfg.encoder_layers + 3 * L + 1) * d + 2 * d,
    }.get(cfg.name, 0)


@pytest.mark.parametrize("arch", jcfg.ARCH_NAMES)
def test_materialised_tree_against_param_count(arch):
    cfg = tcfg.get_config(arch)
    with FakeTensorMode():
        tree = get_model(cfg).init(seed=0, device="cpu")
        n = sum(t.numel() for _, t in named_leaves(tree))
    assert n - cfg.param_count() == _tree_minus_analytic(cfg)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_constants_come_from_the_table():
    cs = _chip_smoke()
    train = tcfg.get_shape("train_4k")
    assert cs.TR_SEQ == train.seq_len
    assert cs.TR_PARAMS == tcfg.get_config(cs.TR_ARCH).param_count()
    assert cs.FM_LONG == tcfg.get_shape("long_500k").seq_len
    for arch, (_rows, seq, _micro, n_params) in cs.FM_TRAIN.items():
        cfg = tcfg.get_config(arch)
        if arch != "whisper-tiny":  # whisper trains at its published 448 tokens
            assert seq == train.seq_len
        # the trees these archs materialise differ from param_count
        assert n_params == cfg.param_count() + _tree_minus_analytic(cfg) != cfg.param_count()
