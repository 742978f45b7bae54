"""Black-box CLI tests — the four run_tests classes (reference run_tests:1-82)
plus flag-parsing parity checks, driven through the real executables."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MTX = os.path.join(REPO, "tests", "data", "small.mtx")

ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    PYTHONPATH=REPO,
)


@pytest.fixture(scope="module", autouse=True)
def small_matrix():
    os.makedirs(os.path.dirname(MTX), exist_ok=True)
    sys.path.insert(0, REPO)
    from abft_sparse_cg.utils.matgen import spd_tridiagonal, write_mm_triangle

    rows, cols, vals, n = spd_tridiagonal(128)
    write_mm_triangle(MTX, rows, cols, vals, n)
    yield


def run_cg(fmt, *args, timeout=300):
    exe = os.path.join(REPO, "bin", f"cg-{fmt}")
    return subprocess.run(
        [sys.executable, exe, *args],
        capture_output=True, text=True, env=ENV, timeout=timeout,
    )


BASE = ["-f", MTX, "-b", "4", "--seed", "7", "--dtype", "f64"]


def test_list_contract():
    """--list output is machine-readable: \\ttarget-mode lines."""
    p = run_cg("csr", "--list")
    assert p.returncode == 0
    impls = re.findall(r"^\t(\S+)-(\S+)$", p.stdout, re.M)
    assert ("jnp", "none") in impls
    assert ("jnp", "secded") in impls
    assert len(impls) >= 6


def list_impls(fmt):
    p = run_cg(fmt, "--list")
    return re.findall(r"^\t(\S+)-(\S+)$", p.stdout, re.M)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_class1_clean_run_every_impl(fmt):
    """run_tests:10-22 — every registered impl exits 0 with no flips."""
    for target, mode in list_impls(fmt):
        p = run_cg(fmt, *BASE, "-t", target, "-m", mode)
        assert p.returncode == 0, f"{target}-{mode}: {p.stdout}\n{p.stderr}"
        assert "time taken =" in p.stdout
        assert re.search(r"iteration\s+\d+ :  rr =", p.stdout)
        assert "total error = " in p.stdout


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_class2_sed_detects(fmt):
    """run_tests:25-42 — sed modes with -x print 'error detected at index'."""
    for target, mode in list_impls(fmt):
        if "sed" not in mode or target == "pallas":
            continue  # pallas == jnp on CPU hosts; class 1 smokes its wiring
        p = run_cg(fmt, *BASE, "-t", target, "-m", mode, "-x")
        assert "error detected at index" in p.stdout, p.stdout
        assert p.returncode == 1


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_class3_sec_corrects(fmt):
    """run_tests:45-62 — sec modes with -x still exit 0."""
    for target, mode in list_impls(fmt):
        if "sec" not in mode or target == "pallas":
            continue
        p = run_cg(fmt, *BASE, "-t", target, "-m", mode, "-x")
        assert p.returncode == 0, f"{target}-{mode}: {p.stdout}\n{p.stderr}"
        assert "[ECC] corrected" in p.stdout


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_class4_secded_double_detect(fmt):
    """run_tests:65-82 — secded with -x 2 prints 'double-bit error detected'.

    A 2-bit injection can hit the same bit twice and cancel (reference
    quirk), or land both flips s.t. they alias; retry across seeds like
    the reference retries across runs.
    """
    for target, mode in list_impls(fmt):
        if "secded" not in mode or target == "pallas":
            continue
        seen = False
        for seed in range(1, 15):
            p = run_cg(fmt, "-f", MTX, "-b", "4", "--dtype", "f64",
                       "--seed", str(seed), "-t", target, "-m", mode, "-x", "2")
            if "double-bit error detected" in p.stdout:
                assert p.returncode == 1
                seen = True
                break
        assert seen, f"{target}-{mode}: no double-bit detection in 14 seeds"


def test_injection_banner_format():
    p = run_cg("csr", *BASE, "-t", "jnp", "-m", "sec8", "-x")
    m = re.search(r"\*\*\* flipping bit (\d+) at index (\d+) \*\*\*", p.stdout)
    assert m, p.stdout
    # sec8 corrects the exact bit that was flipped.
    c = re.search(r"\[ECC\] corrected (?:bit (\d+)|overall parity bit) at index (\d+)",
                  p.stdout)
    assert c, p.stdout
    assert c.group(2) == m.group(2)
    if c.group(1):
        assert c.group(1) == m.group(1)


def test_value_region_injection_restricts():
    for fmt, lo, hi in [("csr", 0, 64), ("coo", 64, 128)]:
        p = run_cg(fmt, *BASE, "-t", "jnp", "-m", "sec7", "-x", "VALUE")
        bit = int(re.search(r"flipping bit (\d+)", p.stdout).group(1))
        assert lo <= bit < hi


def test_config_echo_block():
    p = run_cg("csr", *BASE, "-t", "jnp", "-m", "none")
    assert re.search(r"implementation\s+= jnp-none", p.stdout)
    assert re.search(r"matrix size\s+= 512 x 512", p.stdout)
    assert re.search(r"matrix block size\s+= 128 x 128", p.stdout)
    assert re.search(r"number of non-zeros\s+= \d+ \(", p.stdout)
    assert re.search(r"convergence threshold = 0.001", p.stdout)


def test_bad_args():
    for args, msg in [
        (["-c", "zzz"], "Invalid convergence threshold"),
        (["-b", "0"], "Invalid number of blocks"),
        (["--wat"], "Unrecognized argument '--wat'"),
        (["-x", "0"], "Invalid bit-flip parameter"),
    ]:
        p = run_cg("csr", *args)
        assert p.returncode == 1
        assert msg in p.stdout


def test_missing_impl_and_file():
    p = run_cg("csr", "-t", "gpu", "-m", "none")
    assert p.returncode == 1
    assert "No implementation found for gpu-none" in p.stderr
    p = run_cg("csr", "-f", "/nonexistent.mtx")
    assert p.returncode == 1
    assert "Failed to open '/nonexistent.mtx'" in p.stdout


def test_help_exits_zero():
    p = run_cg("csr", "--help")
    assert p.returncode == 0
    assert "--inject-bitflip" in p.stdout


def test_deterministic_with_seed():
    p1 = run_cg("csr", *BASE, "-t", "jnp", "-m", "secded", "-x")
    p2 = run_cg("csr", *BASE, "-t", "jnp", "-m", "secded", "-x")
    strip = lambda s: re.sub(r"time = +[\d.]+ ms|taken = +[\d.]+ ms", "", s)
    assert strip(p1.stdout) == strip(p2.stdout)


def test_check_interval_pallas_wiring():
    """--check-interval reaches the pallas target's lazy schedule
    through the backend: the CLI flag sets the env knob, the pallas
    backend keys its solver cache on it, and the lazy solve corrects an
    injected fault (exit 0).  The route taken is printed."""
    exe = os.path.join(REPO, "bin", "cg-csr")
    p = subprocess.run(
        [sys.executable, exe, "-f", MTX, "-b", "8", "--seed", "7",
         "--dtype", "f32", "-t", "pallas", "-m", "secded", "-x",
         "--check-interval", "4"],
        capture_output=True, text=True, env=ENV, timeout=600,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "corrected bit" in p.stdout
    assert "time taken" in p.stdout
    assert "spmv route = xla-live" in p.stdout


@pytest.mark.parametrize("preset", [None, "9"])
def test_check_interval_scoped_to_invocation(monkeypatch, capsys, preset):
    """--check-interval's effect is scoped to the invocation: cli.main
    communicates it to the backends via ABFT_CHECK_INTERVAL but restores
    the prior environment on exit (including the SystemExit path), so a
    later in-process main() without the flag is not silently lazy."""
    from abft_sparse_cg import cli

    if preset is None:
        monkeypatch.delenv("ABFT_CHECK_INTERVAL", raising=False)
    else:
        monkeypatch.setenv("ABFT_CHECK_INTERVAL", preset)
    with pytest.raises(SystemExit) as ex:
        cli.main([*BASE, "-t", "jnp", "-m", "secded",
                  "--check-interval", "4"], fmt="csr")
    assert ex.value.code == 0
    assert os.environ.get("ABFT_CHECK_INTERVAL") == preset
    out = capsys.readouterr().out
    assert "time taken" in out


def test_checkpoint_flags_segment_and_resume(tmp_path):
    """--checkpoint PATH snapshots between segments; a run truncated by
    -i then re-invoked with --resume completes from the snapshot and
    matches the straight run's iteration count."""
    ck = str(tmp_path / "ck.npz")
    straight = run_cg("csr", *BASE, "-t", "jnp", "-m", "secded", "--quiet")
    want = re.search(r"ran for (\d+) iterations", straight.stdout).group(1)

    p1 = run_cg("csr", *BASE, "-t", "jnp", "-m", "secded", "--quiet",
                "-i", "4", "--checkpoint", ck, "--checkpoint-every", "2")
    assert p1.returncode == 0, p1.stdout + p1.stderr
    assert "ran for 4 iterations" in p1.stdout
    assert os.path.exists(ck)

    p2 = run_cg("csr", *BASE, "-t", "jnp", "-m", "secded",
                "--checkpoint", ck, "--resume")
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert f"ran for {want} iterations" in p2.stdout
    assert "total error" in p2.stdout
    # The snapshot's rr trace was sized for the truncated run; the
    # resumed run must regrow it — every iteration's residual line
    # prints, none are reported untraced.
    assert len(re.findall(r"^iteration ", p2.stdout, re.M)) == int(want)
    assert "untraced" not in p2.stdout


def test_checkpoint_pallas_corrects_fault(tmp_path):
    """--checkpoint on the pallas target drives the segmented live
    solve: it corrects an injected fault and exits 0."""
    ck = str(tmp_path / "ck.npz")
    exe = os.path.join(REPO, "bin", "cg-csr")
    p = subprocess.run(
        [sys.executable, exe, "-f", MTX, "-b", "8", "--seed", "7",
         "--dtype", "f32", "-t", "pallas", "-m", "secded", "-x",
         "--checkpoint", ck, "--checkpoint-every", "5"],
        capture_output=True, text=True, env=ENV, timeout=600,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "corrected bit" in p.stdout
    assert os.path.exists(ck)


def test_checkpoint_unsupported_target_fails_cleanly(tmp_path):
    """cpu/native has no segmented runner: a clean one-line error, not a
    traceback (reference-style loud failure for unsupported options)."""
    p = run_cg("csr", *BASE, "-t", "cpu", "-m", "none",
               "--checkpoint", str(tmp_path / "ck.npz"))
    assert p.returncode == 1
    assert "options unsupported for target 'cpu'" in p.stdout
    assert "Traceback" not in p.stderr


def test_check_interval_auto_stays_symbolic():
    """--check-interval auto is resolved by the backend
    (tests/test_lazy_periter.py::test_check_interval_auto_policy), so
    the CLI keeps it symbolic for the env handoff."""
    from abft_sparse_cg import cli

    params = cli.parse_arguments(["--check-interval", "auto"], "csr")
    assert params["check_interval"] == "auto"
    params = cli.parse_arguments(["--check-interval", "7"], "csr")
    assert params["check_interval"] == 7
