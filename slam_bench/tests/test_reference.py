"""The plain reference against the program's own f32 nets and NMS on the
CPU, at a small size: the reference has to be the published nets, or the
comparison that decides `correct` judges against the wrong thing."""

import numpy as np
import torch

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.models.ppg_net import load_net
from ppg_slam_tpu_torch.ops.nms import nms_keypoints
from slam_bench import registry
from slam_bench.reference import frontend as ref


def image():
    c = testing.render_corridor(n_frames=2, seed=3, cam=testing.CAM)
    return c.frames[1][:128, :160].copy()


def test_nets_and_nms_equal_the_programs_f32_path():
    img = image()
    weights = ref.load_weights(registry.ROOT + "/assets/ppg_weights.npz",
                               "cpu")
    got = ref.Nets(weights).forward(torch.from_numpy(img))
    with torch.no_grad():
        want = load_net(device="cpu")(
            torch.from_numpy(img).float()[None, None] / 255.0)
    torch.testing.assert_close(got["junc"], want["junc_prob"][0],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(got["desc"], want["desc"][0], rtol=1e-5,
                               atol=1e-5)
    xy, _, valid = nms_keypoints(want["junc_prob"][0])
    np.testing.assert_array_equal(ref.greedy_nms(got["junc"].numpy()),
                                  xy[valid].numpy())


def test_a_side_equal_to_the_reference_reads_zero_and_int8_does_not():
    img = torch.from_numpy(image())
    weights = ref.load_weights(registry.ROOT + "/assets/ppg_weights.npz",
                               "cpu")
    a = ref.Nets(weights).forward(img)
    b = ref.Nets(weights, int8=True).forward(img)
    xy = ref.greedy_nms(a["junc"].numpy())

    def same(p):
        return p.astype(np.float32)

    assert ref.pooled([ref.compare(a, xy, same(xy), *ref.control_side(
        a, same))]) == dict(kp_miss=0.0, score_gap=0.0, desc_gap=0.0)
    got = ref.pooled([ref.compare(a, xy, same(xy), *ref.control_side(
        b, same))])
    assert got["kp_miss"] > 0 and got["score_gap"] > 0 and \
        got["desc_gap"] > 0
    # nothing matched: the gaps cannot be read, and say so
    none = ref.pooled([ref.compare(a, xy, same(xy), np.zeros((0, 2)),
                                   np.zeros(0), torch.zeros(0, 256))])
    assert none["kp_miss"] == 1.0 and none["desc_gap"] == float("inf")
