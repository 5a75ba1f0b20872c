"""The port's CLI keys that is3d_tpu's CLI consumes before its Config
does: the pod keys run only all three together (a missing one is a usage
error, exit code 2; two ranks against one process are in
tests/test_torch_pod.py), ``host_devices`` raises (a decided difference:
the port's processes hold one device each), and ``platform`` names the
device (cpu -> device=cpu, gpu or cuda -> device=cuda); a platform that
contradicts ``device=``, or is none of those, is a usage error."""

import pytest

from is3d_tpu_torch import cli, testing


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return testing.write_synthetic_run_dir(
        str(tmp_path_factory.mktemp("cli") / "run"), 8, 5, 2, seed=4)


@pytest.mark.parametrize("key,value", [
    ("multihost_coordinator", "localhost:1234"), ("multihost_nproc", "2"),
    ("multihost_pid", "0"), ("host_devices", "8")])
def test_multi_device_keys_raise_naming_slice_11(run_dir, key, value,
                                                 capsys):
    """These keys raised NotImplementedError naming slice 11 until pod
    mode was ported: a pod key alone is now a usage error naming the two
    missing ones, and host_devices raises naming its decided
    difference."""
    if key == "host_devices":
        with pytest.raises(NotImplementedError, match="no meaning"):
            cli.main([run_dir, f"{key}={value}"])
        return
    assert cli.main([run_dir, "device=cpu", f"{key}={value}"]) == 2
    first = capsys.readouterr().err.splitlines()[0]
    assert first.startswith("pod mode needs all of")
    assert key not in first.split("missing")[1]


def test_platform_cpu_runs_on_the_cpu(run_dir, capsys):
    assert cli.main([run_dir, "platform=cpu", "precision=f32"]) == 0
    assert "  device = cpu" in capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ["platform=cpu", "device=cuda"], ["platform=gpu", "device=cpu"],
    ["platform=tpu"]])
def test_platform_contradicting_or_unknown_is_refused(run_dir, args,
                                                     capsys):
    assert cli.main([run_dir] + args) == 2
    assert "usage:" in capsys.readouterr().err
