"""The port's kernel roofline (``repro_torch.roofline.kernels``) on the CPU.

Its cost model is the reference's (``repro.roofline.kernels``) at fp32 with
no mask; two divergences keep the bound a lower bound of what a kernel
must do: attention's bytes at the operands' width, and a causal or
windowed call's FLOPs over the pairs a query sees.  The peaks are one
NVIDIA H100 SXM's, never a TPU's.
"""
import numpy as np
import pytest

from repro.roofline import kernels as jroofline

from repro_torch.roofline import kernels as roofline

INFOS = {
    "glm_grad": {"dtype": "float32", "n": 4096, "d": 512},
    "glm_sgd": {"dtype": "float32", "n": 2048, "d": 256, "micro_batch": 8},
    "glm_sparse": {"dtype": "float32", "sparse": True, "n": 2048, "d": 4096,
                   "k": 16},
    "glm_sgd_sparse": {"dtype": "float32", "sparse": True, "n": 1024,
                       "d": 1024, "k": 16, "micro_batch": 8},
    "glm_score": {"dtype": "float32", "sparse": True, "n": 128, "d": 300,
                  "k": 69},
    "flash_attn": {"dtype": "float32", "batch": 2, "heads_q": 4,
                   "heads_kv": 2, "seq_q": 256, "seq_k": 256,
                   "head_dim": 64},
}


@pytest.mark.parametrize("kernel", sorted(INFOS))
def test_cost_equals_the_references_at_fp32_without_a_mask(kernel):
    assert roofline.kernel_cost(kernel, INFOS[kernel]) \
        == jroofline.kernel_cost(kernel, INFOS[kernel])


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        roofline.kernel_cost("nope", {})


def _mask_pairs(sq, sk, causal, window):
    qi = np.arange(sq)[:, None] + (sk - sq)
    kj = np.arange(sk)[None]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= qi >= kj
    if window:
        mask &= qi - kj < window
    return int(mask.sum())


@pytest.mark.parametrize("sq,sk,causal,window", [
    (256, 256, True, None), (5, 37, True, None), (33, 70, True, 9),
    (20, 50, False, 7), (1, 4096, False, None), (8192, 8192, True, 4096)])
def test_visible_pairs_match_the_end_aligned_mask(sq, sk, causal, window):
    assert roofline.visible_pairs(sq, sk, causal, window) \
        == _mask_pairs(sq, sk, causal, window)


def test_causal_attention_counts_the_visible_pairs():
    info = dict(INFOS["flash_attn"], causal=True)
    full = roofline.kernel_cost("flash_attn", INFOS["flash_attn"])["flops"]
    got = roofline.kernel_cost("flash_attn", info)["flops"]
    assert got == 4.0 * 2 * 4 * 64 * (256 * 257 // 2)
    assert got < full == jroofline.kernel_cost("flash_attn", info)["flops"]
    windowed = roofline.kernel_cost("flash_attn", dict(info, window=16))
    assert windowed["flops"] == 4.0 * 2 * 4 * 64 * _mask_pairs(256, 256,
                                                                 True, 16)


def test_bf16_attention_moves_half_the_bytes():
    fp32 = roofline.kernel_cost("flash_attn", INFOS["flash_attn"])
    bf16 = roofline.kernel_cost("flash_attn",
                                dict(INFOS["flash_attn"], dtype="bfloat16"))
    assert bf16["hbm_bytes"] * 2 == fp32["hbm_bytes"]
    assert bf16["flops"] == fp32["flops"]
    # the GLM kernels read fp32 whatever their operands' dtype
    grad = dict(INFOS["glm_grad"], dtype="bfloat16")
    assert roofline.kernel_cost("glm_grad", grad) \
        == roofline.kernel_cost("glm_grad", INFOS["glm_grad"])


def test_the_peaks_are_the_h100s():
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_FLOPS_PER_S,
            roofline.BF16_FLOPS_PER_S) == (3.35e12, 67e12, 989e12)
    assert roofline.peak_flops("flash_attn", dict(INFOS["flash_attn"],
                                                  dtype="bfloat16")) == 989e12
    assert roofline.peak_flops("flash_attn", INFOS["flash_attn"]) == 67e12
    assert roofline.peak_flops("glm_score", INFOS["glm_score"]) == 67e12


@pytest.mark.parametrize("kernel", sorted(INFOS))
def test_annotate_fields_and_fraction(kernel):
    info = INFOS[kernel]
    out = roofline.annotate(kernel, info)
    assert not any(k.startswith("tpu_") for k in out)
    assert out["peaks"]["device"] == "NVIDIA H100 SXM"
    assert out["bound_s"] == max(out["compute_s"], out["memory_s"])
    assert out["bound"] == ("compute" if out["compute_s"] >= out["memory_s"]
                            else "memory")
    assert "roofline_fraction" not in out
    for wall in (out["bound_s"], 3 * out["bound_s"], 1.0):
        timed = roofline.annotate(kernel, info, wall)
        assert 0 < timed["roofline_fraction"] <= 1.0
        assert timed["achieved_gflops"] == pytest.approx(
            out["flops"] / wall / 1e9)
