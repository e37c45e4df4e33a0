"""The dual-stream (RGB + flow) backbone's blocks and trunk and the packed
flow-JPEG decoder in the port against the JAX package's, on the CPU
(helpers, inputs and tolerances as tests/test_torch_backbones.py)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backbones import _body_state, _close_maps, _filled, _image, _jax_apply, _nchw
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W


# ---------------------------------------------------------- dual stream
@pytest.mark.parametrize("fusion", ["sum", "concat"])
@pytest.mark.parametrize("project", [True, False], ids=["projecting", "identity"])
def test_dual_bottleneck_matches_jax(fusion, project):
    """Both fusions and both shortcuts: the projecting one reads the fused
    input, the identity one the input from before the fusion."""
    from transfusion_torch.models.dual_stream import DualBottleneck
    from transfusion_tpu.models.dual_stream import DualBottleneck as JBlock

    x, extra = _image(8, c=16, hw=(8, 12)), _image(9, c=8, hw=(8, 12))
    jm = JBlock(mid=4, stride=1, project=project, fusion=fusion)
    variables = _filled(jm, jnp.asarray(x), jnp.asarray(extra))
    want = _jax_apply(jm, variables, jnp.asarray(x), jnp.asarray(extra))
    state = W.resnet_state_dict_from_jax({"layer1_0": variables["params"]})
    port = DualBottleneck(16, 8, 4, 1, False, project, fusion)
    port.load_state_dict({k.removeprefix("layer1.0."): v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        _close_maps(port(_nchw(x), _nchw(extra)), want, 2e-5)


@pytest.mark.parametrize("fusion", ["sum", "concat"])
def test_dual_stream_resnet_matches_jax(fusion):
    from transfusion_torch.models.dual_stream import DualStreamResNet
    from transfusion_tpu.models.dual_stream import DualStreamResNet as JTrunk

    x, flow = _image(10), _image(11, c=2)
    jm = JTrunk(stage_sizes=(1, 1, 1, 1), fusion=fusion)
    variables = _filled(jm, jnp.asarray(x), jnp.asarray(flow))
    want = _jax_apply(jm, variables, jnp.asarray(x), jnp.asarray(flow))
    port = DualStreamResNet((1, 1, 1, 1), fusion=fusion)
    port.load_state_dict(_body_state(variables), strict=True)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(flow))
    for k in want:
        _close_maps(got[k], want[k], 2e-5, k)


def test_dual_stream_with_zero_fusion_is_the_plain_resnet():
    """tests/test_dual_stream.py's oracle over the whole trunk: with every
    fuse/proj weight zero under sum fusion, the RGB maps equal the plain
    ResNet's with shared weights bit for bit (f32)."""
    from transfusion_torch.models.dual_stream import DualStreamResNet
    from transfusion_torch.models.resnet import ResNet

    dual = W.init_random_(DualStreamResNet((1, 2, 1, 1)), seed=6)
    with torch.no_grad():
        for name, p in dual.named_parameters():
            if ".fuse.proj." in name:
                p.zero_()
    plain = ResNet((1, 2, 1, 1))
    plain.load_state_dict({k: v for k, v in dual.state_dict().items()
                           if ".fuse." not in k and not k.startswith("flow_")}, strict=True)
    x, flow = _nchw(_image(12)), _nchw(_image(13, c=2))
    with torch.no_grad():
        got, want = dual(x, flow), plain(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------- flow decoder
@pytest.mark.parametrize("img_shape", [(32, 48, 2), (64, 96, 2)], ids=["as_stored", "resized"])
def test_decode_flow_jpg_matches_jax(img_shape):
    """A packed flow JPEG encoded here with OpenCV decodes to JAX's array."""
    from transfusion_torch.data.readers import decode_flow_jpg
    from transfusion_tpu.data.readers import decode_flow_jpg as j_decode

    rng = np.random.default_rng(20)
    packed = rng.integers(0, 256, (64, 48)).astype(np.uint8)  # u over v, 32 x 48 each
    ok, buf = cv2.imencode(".jpg", packed, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    got = decode_flow_jpg(buf.tobytes(), load_shape=(2, 32, 48), img_shape=img_shape)
    want = j_decode(buf.tobytes(), load_shape=(2, 32, 48), img_shape=img_shape)
    assert got.shape == img_shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
