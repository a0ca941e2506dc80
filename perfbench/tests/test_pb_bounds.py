"""Each function's operation and byte counts against a hand count at one
shape, and the whole step's count for ``step_mfu``."""
import pytest

from pbcore.layers import module

SHAPE = {"B": 2, "N": 3, "F": 1, "C": 2, "T": 8, "Co": 4, "Ct": 4, "K": 2, "H": 2, "dk": 4,
         "dv": 4, "d": 8, "P": 2, "nb_block": 2, "needs_dx": True, "A": 3, "BS": 2}

# (flops, bytes) worked out by hand from each file's docstring, float32
HAND = {
    # 2·2·2·9·16 + 6·2·2·9; 4·(36 + 36 + 96 + 192)
    "cheb_sat": (1368, 1440),
    # 2·2·2·3·4·(4 + 16) + 2·2·3·2·16·4; 4·(96 + 48 + 96 + 192 + 16)
    "bell_fused": (3456, 1792),
    # 4·2·3·2·16·4 + 2·2·2·3·4·16; 4·(192 + 96 + 96 + 32)
    "bell_k1": (4608, 1664),
    # 2·2·2·3·4·16; 4·(192 + 48 + 16 + 96)
    "bell_k2": (1536, 1408),
    # 2·6·(6·3 + 4·5 + 2·7)·4·8; 4·(192 + 288 + 504)
    "gtu_fwd": (19968, 3936),
    "gtu_bwd": (39936, 6720),
    # 2304 + 768 + 4096 + 5·2·2·64 + 10·2·8·3; 4·(96 + 512 + 102)
    "tat_fwd": (8928, 2840),
    "tat_bwd": (14336, 3440),
    # 768 + 1536 + 1536 + 288 + 1152 + 8·2·2·9; 4·(48 + 96 + 192 + 274 + 27)
    "spatial_fwd": (5568, 2548),
    # 2·3840 + 2·288 + 2·1152; 4·(96 + 96 + 192 + 96 + 548 + 27)
    "spatial_bwd": (10560, 4220),
}


@pytest.mark.parametrize("function", sorted(HAND))
def test_count_by_hand(function):
    assert module("bounds", function).count(dict(SHAPE), 4) == HAND[function]


def test_step_count_by_hand():
    """One block's forward 18,944 operations a window (×2 a batch of two),
    the head 2·(49,152 + 1,536); a train step three forwards."""
    run = {"blocks": [dict(SHAPE), dict(SHAPE)], "train_steps": 1, "val_batches": 1}
    step = 2 * (2 * 18944) + 2 * (49152 + 1536)
    assert module("bounds", "dstagnn_step").flops(run) == 3 * step + step


def test_backward_leaves_out_dx_where_none_is_taken():
    s = dict(SHAPE, needs_dx=False)
    assert module("bounds", "tat_bwd").count(s, 4)[0] < HAND["tat_bwd"][0]
    assert module("bounds", "spatial_bwd").count(s, 4)[0] == HAND["spatial_bwd"][0] - 1152
