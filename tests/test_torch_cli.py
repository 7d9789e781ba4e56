"""The port's command line against the JAX package's: the same option
strings, the same ``Config`` for the same argv, the same refusals; what
the port's CLI raises where a library is missing, and for the bench,
which it does not run yet."""
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


@pytest.mark.parametrize("action,error", [
    # the GUI's control channel needs websockets, blocked here
    ("gui", (ImportError, "websockets"))])
def test_unported_actions_raise(action, error, monkeypatch):
    monkeypatch.setitem(sys.modules, "websockets", None)
    with pytest.raises(error[0], match=error[1]):
        cli.main([action, "--gui-port", "0", "--gui-mjpeg-port", "0"],
                 device="cpu")


def test_bench_action_runs_the_bench(monkeypatch):
    """``bench`` calls the port's ``bench.main`` with no arguments and the
    device, as the JAX CLI runs bench.py's ``main``, and returns its
    record."""
    from transflow_tpu_torch import bench
    calls = []
    monkeypatch.setattr(bench, "main", lambda argv, device=None:
                        calls.append((argv, device)) or {"value": 1.0})
    assert cli.main(["bench"], device="cpu") == {"value": 1.0}
    assert calls == [([], "cpu")]


def test_gui_action_starts_the_server(monkeypatch):
    """``gui`` calls ``start_gui`` with the GUI flags and the device, as
    the JAX CLI calls its own; with no card and no device it raises."""
    import torch
    from transflow_tpu_torch.gui import server
    calls = []
    monkeypatch.setattr(server, "start_gui",
                        lambda *args, **kwargs: calls.append((args, kwargs)))
    cli.main(["gui", "--gui-host", "127.0.0.1", "--gui-port", "8123",
              "--gui-mjpeg-port", "8124"], device="cpu")
    assert calls == [(("127.0.0.1", 8123, 8124), {"device": "cpu"})]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["gui"])


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


def _free_port():
    import socket
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@pytest.mark.parametrize("extra,error", [
    # no libav shim, no native IO library, no ffmpeg binary, no cv2: the
    # encoder chain ends at cv2.VideoWriter, whose import names cv2
    (["-o", "out.mp4"], (ImportError, "cv2")),
    # the MJPEG server runs (no client), as the JAX package's
    (["-o", "mjpeg:{port}:127.0.0.1"], None),
    # no -o, or -O: the preview window, which needs a display
    ([], (RuntimeError, "needs a display")),
    (["-o", "%04d.ppm", "-O"], (RuntimeError, "needs a display")),
    # no shim: no motion vectors, as the JAX source without PyAV or it
    (["-o", "%04d.ppm", "--mv"], (ImportError, "native libav shim")),
], ids=["video", "mjpeg", "window", "preview", "mv"])
def test_unported_inputs_and_outputs_raise(sequence, tmp_path, monkeypatch,
                                           extra, error):
    """What each route does on a machine without a display, the libav
    shim, the native IO library, an ffmpeg binary and (for the encoder)
    cv2 (each monkeypatched away); the window's refusal is the JAX
    CLI's own."""
    import shutil
    from transflow_tpu_torch import av_native, native
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(av_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    if error is not None and error[1] == "cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    extra = [arg.format(port=_free_port()) for arg in extra]
    argv = [sequence, "-p", "noise", "--no-exec", "--overwrite", *extra]
    if error is None:
        pipeline = cli.main(argv, device="cpu")
        assert pipeline.cursor == 2
        return
    with pytest.raises(error[0], match=error[1]):
        cli.main(argv, device="cpu")
    if error[0] is RuntimeError:
        monkeypatch.undo()
        monkeypatch.chdir(tmp_path)
        monkeypatch.delenv("DISPLAY", raising=False)
        with pytest.raises(RuntimeError, match=error[1]):
            jcli.main(argv)


def test_video_input_raises(tmp_path, monkeypatch):
    """A video that does not open raises ``FileNotFoundError``, as the JAX
    CLI does; with cv2 missing the open names it."""
    argv = [str(tmp_path / "clip.mp4"), "-p", "noise", "-o",
            str(tmp_path / "%04d.ppm"), "--no-exec"]
    for run in (lambda: jcli.main(argv),
                lambda: cli.main(argv, device="cpu")):
        with pytest.raises(FileNotFoundError, match="Could not open"):
            run()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        cli.main(argv, device="cpu")


# ---------------------------------------------------------------------------
# flow post-processing, merges and every layer class, disk to disk
# ---------------------------------------------------------------------------

POST_FRAMES = 6
POST_H, POST_W = 48, 64


@pytest.fixture(scope="module")
def post_inputs(tmp_path_factory):
    """Three six-frame ``.flow.zip`` archives (one forward, two backward:
    no estimator, so both packages post-process the same raw flows), a
    fractional PGM mask and a two-tap dyadic kernel (one rounding per
    output in any order of sums, so the convolutions agree bit for bit)."""
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.output.archive import NumpyArchiveOutput
    from transflow_tpu_torch.utils.imageio import write_netpbm
    root = tmp_path_factory.mktemp("cli_post")
    rng = np.random.default_rng(8)
    paths = {}
    for name, direction, scale in (("fwd", Direction.FORWARD, 5.0),
                                   ("a", Direction.BACKWARD, 4.0),
                                   ("b", Direction.BACKWARD, 2.0)):
        paths[name] = str(root / f"{name}.flow.zip")
        out = NumpyArchiveOutput(paths[name], {
            "width": POST_W, "height": POST_H, "framerate": 25.0,
            "direction": direction.value}, replace=True)
        for _ in range(POST_FRAMES):
            out.write_array((rng.standard_normal((POST_H, POST_W, 2))
                             * scale).astype(np.float32))
        out.close()
    ii, jj = np.indices((POST_H, POST_W))
    paths["gradient"] = str(root / "gradient.pgm")
    write_netpbm(paths["gradient"], ((ii * 9 + jj * 5) % 256)
                 .astype(np.uint8))
    paths["kernel"] = str(root / "kernel.npy")
    np.save(paths["kernel"], np.array([[0, 0, 0], [0, 0.5, 0.25],
                                       [0, 0, 0]], np.float32))
    paths["root"] = root
    return paths


def _render(package, argv, out_dir):
    """``argv`` rendered by ``package`` ("jax", or the port on the CPU)
    into ``out_dir/%04d.ppm``; returns the frames."""
    from transflow_tpu_torch.utils.imageio import read_netpbm
    out_dir.mkdir(exist_ok=True)
    argv = list(argv) + ["-o", str(out_dir / "%04d.ppm"), "--no-exec",
                         "--overwrite"]
    if package == "jax":
        jcli.main(argv)
    else:
        cli.main(argv, device="cpu")
    names = sorted(p.name for p in out_dir.glob("*.ppm"))
    return np.stack([read_netpbm(str(out_dir / n)) for n in names])


def _layers_argv(p):
    """introduction, sum, static and moveref layers, each with the four
    layer masks, and pixmaps with ``-i`` introduction masks."""
    masks = ["--move-mask-source", "rect:80%:70%",
             "--move-mask-destination", "circle:45%:inv", "-m",
             p["gradient"]]
    # a 3-channel pixmap's alpha is 0 or 1: the introduction's fractional
    # alpha mask hides it below 1 (the product and its truncation still
    # run); the other layers take 0/1 alpha masks and show
    return [p["a"], "--seed", "4",
            "-l", "0", "introduction", "-e", "--mask-alpha", p["gradient"],
            *masks,
            "-l", "1", "sum", "-r", "random", "0.2", "--mask-alpha",
            "rect:90%:90%", *masks,
            "-l", "2", "static", "--mask-alpha", "border:5", *masks,
            "-l", "3", "moveref", "-r", "constant", "1.5", "-e",
            "--mask-alpha", "circle:35%", *masks,
            "-p", "noise", "0", "1", "3", "-i", "border-left:50%",
            "-p", "gradient", "0", "2", "-i", "circle:40%",
            "-p", "cnoise", "3"]


def _post_argv(name, p):
    if name == "forward":
        return [p["fwd"], "-d", "forward", "--mask", "circle:45%",
                "--kernel", p["kernel"], "-f",
                "scale=1.5;threshold=1;clip=5", "-p", "noise", "-r",
                "random", "0.1", "--seed", "2"]
    if name == "layers":
        return _layers_argv(p)
    return [p["a"], "--flow", p["b"], "--merge", name.split("-")[1], "-p",
            "noise", "-r", "linear", "-e", "--seed", "3"]


@pytest.mark.parametrize("name", ["forward", "layers"] + [
    f"merge-{m}" for m in ("first", "sum", "average", "difference",
                           "product", "maskbin", "masklin", "absmax")])
def test_postprocess_and_layers_render_like_jax(post_inputs, name):
    """The CLI on ``.flow.zip`` inputs with ``-d forward``, ``--mask``, a
    dyadic ``--kernel`` and scale/threshold/clip filters; two sources
    under each merge; the four layer classes with every layer mask and
    ``-i``: frames bit-equal to the JAX CLI's."""
    argv = _post_argv(name, post_inputs)
    root = post_inputs["root"]
    got = _render("port", argv, root / f"{name}_port")
    want = _render("jax", argv, root / f"{name}_jax")
    assert got.shape == (POST_FRAMES, POST_H, POST_W, 3)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2


@pytest.mark.parametrize("writer,resumer", [("jax", "port"),
                                            ("port", "jax")])
def test_layer_checkpoints_resume_across_packages(post_inputs, writer,
                                                  resumer):
    """A ``.ckpt.zip`` of the four layer classes written by either CLI and
    resumed by the other renders the writer's remaining frames."""
    from transflow_tpu_torch.utils.imageio import read_netpbm
    root = post_inputs["root"]
    out_dir = root / f"ckpt_{writer}"
    argv = _layers_argv(post_inputs) + ["--checkpoint-every", "3"]
    frames = _render(writer, argv, out_dir)
    for k in range(3, POST_FRAMES):
        (out_dir / f"{k:04d}.ppm").unlink()
    ckpt = out_dir / "%04d_00003.ckpt.zip"
    assert ckpt.exists()
    if resumer == "jax":
        jcli.main([str(ckpt), "--no-exec", "--overwrite"])
    else:
        cli.main([str(ckpt), "--no-exec", "--overwrite"], device="cpu")
    resumed = np.stack([read_netpbm(str(out_dir / f"{k:04d}.ppm"))
                        for k in range(3, POST_FRAMES)])
    np.testing.assert_array_equal(resumed, frames[3:])


def test_lk16_preset_renders_like_jax(tmp_path):
    """``-c assets/configs/lk16.json`` (Lucas-Kanade, 16 px macroblocks)
    over a netpbm sequence through both CLIs with ``-F``: the exported
    flows within 1e-4 of JAX's (tests/test_torch_lucas_kanade.py's bar),
    constant over each 16x16 block, and the frames equal but for flows
    that round apart at a .5 edge (<= 1 % of pixels)."""
    from test_torch_engine import _gray_video
    from transflow_tpu_torch.flow.sources.archive import ArchiveFlowSource
    from transflow_tpu_torch.utils.imageio import write_netpbm
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, frame in enumerate(_gray_video(5, 48, 64, seed=6)):
        write_netpbm(str(seq / f"{i:04d}.pgm"), frame)
    preset = os.path.join(REPO, "assets", "configs", "lk16.json")
    argv = [str(seq / "%04d.pgm"), "-c", preset, "-p", "noise", "--seed",
            "1", "-F"]
    frames, flows = {}, {}
    for package in ("port", "jax"):
        out = tmp_path / package
        out.mkdir()
        frames[package] = _render(package, argv, out)
        (archive,) = out.glob("*.flow.zip")
        source = ArchiveFlowSource(str(archive)).open()
        flows[package] = np.stack([np.array(it.array) for it in source])
        source.close()
    assert flows["port"].shape == (4, 48, 64, 2)
    np.testing.assert_allclose(flows["port"], flows["jax"], atol=1e-4,
                               rtol=0)
    assert np.abs(flows["jax"]).max() > 1.0
    block = flows["port"][:, :16, :16]
    assert (block == block[:, :1, :1]).all()
    assert frames["port"].shape == frames["jax"].shape == (4, 48, 64, 3)
    differ = (frames["port"] != frames["jax"]).any(axis=-1).mean()
    assert differ <= 0.01
