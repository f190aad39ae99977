"""The port's train step against ``repro.launch.steps`` on hymba-1.5b
SMOKE (CPU): attention beside the mamba branch, whose scan runs the
chunked route under autograd in training, as ``repro``'s does (no
``scan_tiles``); one and three steps at one and two microbatches, with
``tests/_torch_train.py``'s tolerances."""
import pytest

from _torch_train import check_run, run_both


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match(microbatches):
    check_run(*run_both("hymba-1.5b", 3, microbatches))
