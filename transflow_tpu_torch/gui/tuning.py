"""Live estimator-tuning window.

Counterpart of transflow_tpu/gui/tuning.py: a tkinter panel bound to a
``CvFlowConfig``, on a daemon thread. Each edit goes through
``apply_value``, which bumps ``config.version``; the Engine's
``SourceRuntime`` then builds its estimator step anew with the new
hyper-parameters before the next frame (``engine.py::_maybe_rejit``).
tkinter is imported only inside the window's thread, so the fields,
``coerce_value`` and ``apply_value`` work without it.
"""
import json
import threading

from ..utils.misc import require

FIELDS = [
    # (attribute, label, kind, choices/range)
    ("method", "Method", "choice",
     ["farneback", "horn-schunck", "lukas-kanade", "liteflownet"]),
    ("fb_pyr_scale", "FB pyramid scale", "float", (0.1, 0.9)),
    ("fb_levels", "FB levels", "int", (1, 8)),
    ("fb_winsize", "FB window", "int", (3, 41)),
    ("fb_iterations", "FB iterations", "int", (1, 10)),
    ("fb_poly_n", "FB poly N", "int", (3, 9)),
    ("fb_poly_sigma", "FB poly sigma", "float", (0.5, 3.0)),
    ("fb_downscale", "FB downscale (1=full res)", "int", (1, 8)),
    ("fb_select_warp", "FB select-warp radius (0=gather)", "int", (0, 64)),
    ("hs_alpha", "HS alpha", "float", (0.1, 10.0)),
    ("hs_iterations", "HS iterations", "int", (1, 64)),
    ("hs_decay", "HS decay", "float", (0.0, 1.0)),
    ("hs_delta", "HS delta", "float", (0.0, 10.0)),
    ("lk_window_size", "LK window", "int", (3, 41)),
    ("lk_max_level", "LK max level", "int", (0, 5)),
    ("lk_step", "LK step", "int", (1, 32)),
    ("lfn_warp_bound", "LFN warp bound (0=exact)", "int", (0, 32)),
    ("lfn_scale", "LFN scale (1=exact)", "float", (0.1, 1.0)),
]

FIELD_KINDS = {attr: kind for attr, _, kind, _ in FIELDS}
FIELD_SPECS = {attr: spec for attr, _, _, spec in FIELDS}


def coerce_value(kind: str, raw):
    """Parse a widget string into the field's type; raises ValueError."""
    if kind == "int":
        return int(raw)
    if kind == "float":
        return float(raw)
    return raw


class CvFlowConfigWindow:
    """tkinter panel editing a CvFlowConfig live."""

    def __init__(self, config):
        self.config = config
        self.thread: threading.Thread | None = None
        self._vars = {}

    def start(self):
        require("tkinter", "the live-tuning window")  # its thread's import
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="cv-config-window")
        self.thread.start()

    def apply_value(self, attr: str, raw) -> bool:
        """Coerce a raw widget value and push it into the config (bumping
        ``config.version`` so the engine rebuilds its step). Returns False
        on a half-typed/unparseable value instead of raising — widget handlers
        fire on every keystroke."""
        try:
            value = coerce_value(FIELD_KINDS[attr], raw)
        except ValueError:
            return False
        self.config.update(attr, value)
        return True

    def _run(self):
        import tkinter
        import tkinter.filedialog
        import tkinter.ttk as ttk

        root = tkinter.Tk()
        root.title("transflow-tpu estimator tuning")
        frame = ttk.Frame(root, padding=8)
        frame.grid(sticky="nsew")

        def on_change(attr, var):
            def handler(*_):
                try:
                    self.apply_value(attr, var.get())
                except tkinter.TclError:
                    pass
            return handler

        for row, (attr, label, kind, spec) in enumerate(FIELDS):
            ttk.Label(frame, text=label).grid(row=row, column=0, sticky="w")
            current = getattr(self.config, attr)
            if kind == "choice":
                var = tkinter.StringVar(value=str(current))
                widget = ttk.Combobox(frame, textvariable=var, values=spec,
                                      state="readonly", width=14)
            else:
                var = tkinter.StringVar(value=str(current))
                widget = ttk.Spinbox(
                    frame, textvariable=var, from_=spec[0], to=spec[1],
                    increment=1 if kind == "int" else 0.1, width=8)
            var.trace_add("write", on_change(attr, var))
            widget.grid(row=row, column=1, sticky="ew", pady=1)
            self._vars[attr] = var

        def do_export():
            path = tkinter.filedialog.asksaveasfilename(
                defaultextension=".json")
            if path:
                self.config.to_file(path)

        def do_import():
            path = tkinter.filedialog.askopenfilename()
            if not path:
                return
            with open(path, encoding="utf8") as file:
                for key, value in json.load(file).items():
                    if key in self._vars:
                        self._vars[key].set(str(value))

        def do_reset():
            for attr, label, kind, spec in FIELDS:
                default = self.config.DEFAULTS[attr]
                self._vars[attr].set(str(default))

        buttons = ttk.Frame(frame)
        buttons.grid(row=len(FIELDS), column=0, columnspan=2, pady=6)
        ttk.Button(buttons, text="Import", command=do_import).grid(
            row=0, column=0)
        ttk.Button(buttons, text="Export", command=do_export).grid(
            row=0, column=1)
        ttk.Button(buttons, text="Reset", command=do_reset).grid(
            row=0, column=2)
        root.mainloop()
