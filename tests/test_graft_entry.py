"""Driver entry points: dryrun_multichip builds its mesh from the devices
present (8 virtual CPU devices in the test environment) and refuses to run
on fewer than it was asked for."""

import importlib.util
import os

import pytest

_ENTRY = os.path.join(os.path.dirname(__file__), os.pardir,
                      "__graft_entry__.py")


def _load_entry_module():
    spec = importlib.util.spec_from_file_location("graft_entry", _ENTRY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [9, 64])
def test_dryrun_multichip_raises_beyond_present_devices(n):
    import jax

    assert len(jax.devices()) == 8
    mod = _load_entry_module()
    with pytest.raises(ValueError, match="devices; 8 present"):
        mod.dryrun_multichip(n)


def test_dryrun_multichip_serving_on_present_devices(capsys):
    """Two of the eight devices: 16 streams sharded 8 per device, mid-run
    reset, placement proof — in this process, no re-exec."""
    mod = _load_entry_module()
    mod.dryrun_multichip(2, train=False)
    assert "multi-stream serving step OK on 2-device mesh" in \
        capsys.readouterr().out
