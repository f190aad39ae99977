"""The port's train step against ``repro.launch.steps`` on the MoE,
encoder-decoder and vlm SMOKE configs (CPU), one and three steps at one
and two microbatches, with ``tests/_torch_train.py``'s tolerances:
moonshot-v1-16b-a3b against ``repro``'s transformer on
``first_c_moe_ffn`` (its SMOKE experts overflow, where ``repro``'s MoE
drops a kept token: ROADMAP C), seamless-m4t-medium with encoder frames,
llava-next-mistral-7b with image patches (its loss over the text
positions only)."""
import pytest

from _torch_train import check_run, run_both


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_train_steps_match(arch, microbatches):
    check_run(*run_both(arch, 3, microbatches))
