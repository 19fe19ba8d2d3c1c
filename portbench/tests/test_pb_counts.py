"""The FLOP counts and rooflines against the port's formula and hand
counts."""
import pytest

from portbench.counts import flops, h100, roofline


@pytest.mark.parametrize("seq", [128, 512, 16384])
def test_albert_flops_equal_the_ports(seq):
    from dedloc_tpu_torch.data.mlm import max_predictions_for
    from dedloc_tpu_torch.models.albert import AlbertConfig
    from dedloc_tpu_torch.telemetry.steps import albert_tflops_per_sample

    cfg = AlbertConfig.large(max_position_embeddings=seq)
    ours = flops.albert_tflops_per_sample(1024, 4096, 24, 128, 30000, seq,
                                          max_predictions_for(seq))
    assert ours == albert_tflops_per_sample(cfg, seq, max_predictions_for(seq))


def test_flash_bounds_by_hand():
    # [12, 512, 16, 64]: the forward moves 4 bf16 [B, S, H, D] tensors, the
    # key bias and the row lse: 4 x 12,582,912 + 24,576 + 393,216 bytes
    exp_rate = h100.exp_per_s(132, 1980.0)
    b = roofline.flash_bounds(12, 512, 16, 64, exp_rate)
    assert b["flash_fwd_kernel"] == pytest.approx(50_749_440 / 3.35e12)
    # at S = 16,384 the products bind: 2 x (2 x 2 x 16 x 16384^2 x 64)
    # operations at 989 TFLOP/s
    b = roofline.flash_bounds(2, 16384, 16, 64, exp_rate)
    assert b["flash_fwd_kernel"] == pytest.approx(2 * 2 * 2 * 16 * 16384 ** 2 * 64 / 989e12)
    assert b["flash_bwd_dkdv_kernel"] == pytest.approx(2 * b["flash_fwd_kernel"])
    assert b["flash_bwd_dq_kernel"] == pytest.approx(1.5 * b["flash_fwd_kernel"])


def test_ln_bounds_by_hand():
    # [6144, 1024] bf16: the forward reads x, r and writes y, x-hat (4 rows
    # of 12.58 MB), gamma and beta, rstd
    b = roofline.ln_bounds(6144, 1024)
    assert b["forward"] == pytest.approx((4 * 12_582_912 + 8192 + 24_576) / 3.35e12)
    assert b["backward"] == pytest.approx((3 * 12_582_912 + 24_576 + 12_288) / 3.35e12)


def test_resnet50_convolutions_by_hand():
    convs = list(flops.resnet_convs(224, (3, 4, 6, 3), 64))
    assert len(convs) == 53  # the stem, 16 blocks of 3 and 4 projections
    assert convs[0] == (3, 64, 7, 112)
    assert convs[-1] == (512, 2048, 1, 7)
    # ResNet-50's 4.1 G multiply-adds at 224^2 (He et al.: 3.8 G without
    # the projections' count convention); 2 FLOPs each
    assert flops.conv_flops(224, (3, 4, 6, 3), 64) == pytest.approx(8.17e9, rel=0.01)
    assert [c[3] for c in flops.resnet_convs(96, (3, 4, 6, 3), 64)][-1] == 3
