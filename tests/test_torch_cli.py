"""The port's command line against the JAX package's: the same option
strings, the same ``Config`` for the same argv, the same refusals; and
what the port's CLI raises for what it does not run yet."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from transflow_tpu import cli as jcli
from transflow_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the provenance entries of Config.todict(), which differ run to run
PROVENANCE = ("timestamp", "command")


def _actions(parser):
    return [(a.option_strings, a.dest, type(a).__name__, a.nargs, a.const,
             a.default, a.type, a.choices, a.required, a.metavar)
            for a in parser._actions]


def test_parser_matches_jax():
    got, want = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert [a[0] for a in got] == [a[0] for a in want]
    assert got == want


def _full_argv(tmp_path):
    """tests/test_cli.py::test_full_flag_round_trip's command line."""
    kernel = str(tmp_path / "k.npy")
    np.save(kernel, np.ones((3, 3)) / 9.0)
    return [
        "flow.mp4", "--flow", "extra.mp4", "--merge", "absmax",
        "--mask", "circle:25%", "--kernel", kernel,
        "-f", "scale=2; threshold=0.5", "-d", "forward",
        "-s", "00:00:05", "-t", "00:00:10", "--to", "00:00:20",
        "--repeat", "2", "--lock", "stay", "(1, 0.5)",
        "-p", "image.jpg", "0", "1", "-i", "border-left:50%",
        "--alteration", "overlay.png", "--pixmap-seek", "00:00:01",
        "--pixmap-repeat", "3", "-p", "noise", "1",
        "--background", "#102030", "-l", "0", "moveref",
        "--mask-alpha", "ones", "--move-mask-source", "ones",
        "--move-mask-destination", "ones", "--move-from-empty",
        "--no-move-to-empty", "--no-move-to-filled", "-e",
        "-r", "random", "0.25", "-m", "border:10", "--reset-source",
        "-l", "1", "introduction", "--no-introduce-on-empty",
        "--no-introduce-on-filled", "--no-introduce-moving",
        "--no-introduce-unmoving", "-n", "-a", "--introduce-on-all-empty",
        "-o", "out.mp4", "-o", "mjpeg:9000", "--vcodec", "libx264",
        "--size", "640x480", "--view-flow", "--render-scale", "0.2",
        "--render-colors", "#ff0,#00f,#f0f,#0f0", "--render-binary",
        "--seed", "42", "--batch-frames", "8",
    ]


ARGVS = {
    "headline": ["frames/%04d.pgm", "-p", "noise", "--seed", "0", "-r",
                 "random", "0.01", "-o", "out/%04d.ppm", "-F", "-C"],
    "defaults": ["flow.mp4", "--seed", "3"],
    "replay": ["run.flow.zip", "-p", "pix/%04d.ppm", "2", "-l", "2",
               "-r", "constant", "--seed", "1", "--mesh", "2", "--halo",
               "8", "-d", "backward", "--repeat", "0"],
    "resume": ["out_00012.ckpt.zip", "--seed", "5", "-t", "00:00:01.500"],
    "lock": ["flow.mp4", "--lock", "skip", "t > 1", "-l", "0", "sum",
             "-r", "linear", "--seed", "9", "-c",
             '{"method": "liteflownet"}'],
}


@pytest.mark.parametrize("name", list(ARGVS) + ["full", "json"])
def test_config_matches_jax(tmp_path, name):
    if name == "full":
        argv = _full_argv(tmp_path)
    elif name == "json":
        path = str(tmp_path / "render.json")
        config = jcli.config_from_args(jcli.build_parser().parse_args(
            _full_argv(tmp_path)))
        with open(path, "w") as file:
            json.dump(config.todict(), file)
        argv = [path]
    else:
        argv = ARGVS[name]
    got = cli.config_from_args(cli.build_parser().parse_args(argv)).todict()
    want = jcli.config_from_args(
        jcli.build_parser().parse_args(argv)).todict()
    for key in PROVENANCE:
        got.pop(key)
        want.pop(key)
    assert got == want


BAD_ARGVS = [
    ["flow.mp4", "-r", "bogus"],
    ["flow.mp4", "-r", "random", "x"],
    ["flow.mp4", "-r", "random", "0.1", "2"],
    ["flow.mp4", "-l", "x"],
    ["flow.mp4", "-l", "0", "bogus"],
    ["flow.mp4", "-l", "0", "sum", "3"],
    ["flow.mp4", "-p", "noise", "x"],
    ["flow.mp4", "--pixmap-seek", "00:00:01"],
    ["flow.mp4", "--merge", "median"],
    ["flow.mp4", "-d", "sideways"],
    ["flow.mp4", "--lock", "hold", "t"],
    ["flow.mp4", "--repeat", "two"],
    ["flow.mp4", "--log-level", "LOUD"],
    [],
]


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=lambda a: " ".join(a[1:]))
def test_refusals_match_jax(argv, capsys):
    messages = []
    for parser in (cli.build_parser(), jcli.build_parser()):
        with pytest.raises(SystemExit) as exit_info:
            parser.parse_args(argv)
        assert exit_info.value.code == 2
        messages.append(capsys.readouterr().err.split("error:", 1)[1])
    assert messages[0] == messages[1]


def test_module_entry_point_help_and_version():
    """``python -m transflow_tpu_torch`` parses the command line and
    prints the port's help and version, with no card needed."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for flag, text in [("--help", "usage: transflow-tpu-torch"),
                       ("--version", "transflow-tpu-torch v")]:
        proc = subprocess.run([sys.executable, "-m", "transflow_tpu_torch",
                               flag], capture_output=True, text=True,
                              cwd=REPO, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert text in proc.stdout


@pytest.mark.parametrize("action,item", [("gui", "item 15"),
                                         ("bench", "item 9")])
def test_unported_actions_raise(action, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main([action], device="cpu")


def test_the_cli_needs_a_card_by_default(tmp_path, monkeypatch):
    """Without ``device``, the render runs on the card, and raises
    without one; it never falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["frames/%04d.pgm", "-p", "noise", "-o",
                  str(tmp_path / "%04d.ppm")])


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    from transflow_tpu_torch.utils.imageio import write_netpbm
    root = tmp_path_factory.mktemp("cli_seq")
    rng = np.random.default_rng(0)
    for i in range(3):
        write_netpbm(str(root / f"{i:04d}.pgm"),
                     rng.integers(0, 256, (16, 24), np.uint8))
    return str(root / "%04d.pgm")


@pytest.mark.parametrize("extra,item", [
    (["-o", "out.mp4"], "item 14.2"),        # no ffmpeg binary: no encoder
    (["-o", "mjpeg:9000"], "item 14.2"),
    ([], "item 14.2"),                       # no -o: the preview window
    (["-o", "%04d.ppm", "-O"], "item 14.2"),
    (["-o", "%04d.ppm", "--mv"], "item 14.3"),
], ids=["video", "mjpeg", "window", "preview", "mv"])
def test_unported_inputs_and_outputs_raise(sequence, tmp_path, monkeypatch,
                                           extra, item):
    import shutil
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(NotImplementedError, match=item):
        cli.main([sequence, "-p", "noise", "--no-exec", *extra],
                 device="cpu")


def test_video_input_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 14.2"):
        cli.main(["clip.mp4", "-p", "noise", "-o",
                  str(tmp_path / "%04d.ppm"), "--no-exec"], device="cpu")
