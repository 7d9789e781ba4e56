/* transflow-tpu web client.
 * Mirrors the websocket protocol of the server (gui/server.py):
 *   -> GENERATE {config} | INTERRUPT | RELOAD | FILE_OPEN key | FILE_SAVE key
 *   <- STATUS {json} | DONE | PREVIEW url | ERROR msg | FILE key path
 * Config edits persist in localStorage. Media files preview (and scrub, via
 * the server's /media HTTP-range handler) in the media panel.
 * Grid limits match the reference client (master.js:80-88): 5 layers x 5
 * pixmap sources.
 */
"use strict";

const $ = (id) => document.getElementById(id);
const MAX_LAYERS = 5;
const MAX_PIXMAPS = 5;

const VIDEO_EXT = /\.(mp4|avi|mkv|webm|mov|m4v|mpg|mpeg)$/i;
const IMAGE_EXT = /\.(png|jpe?g|gif|bmp|webp)$/i;

let ws = null;
let pixmaps = [];
let layers = [];

/* ------------------------------------------------------------------ */
/* state persistence                                                    */
/* ------------------------------------------------------------------ */

function saveState() {
  const state = { fields: {}, pixmaps, layers };
  for (const el of document.querySelectorAll("input, select")) {
    if (el.closest("#pixmaps") || el.closest("#layers")) continue;
    state.fields[el.id] = el.type === "checkbox" ? el.checked : el.value;
  }
  localStorage.setItem("transflow-tpu", JSON.stringify(state));
}

function loadState() {
  const raw = localStorage.getItem("transflow-tpu");
  if (!raw) { pixmaps = [newPixmap()]; layers = [newLayer(0)]; return; }
  try {
    const state = JSON.parse(raw);
    for (const [id, value] of Object.entries(state.fields || {})) {
      const el = $(id);
      if (!el) continue;
      if (el.type === "checkbox") el.checked = value; else el.value = value;
    }
    pixmaps = state.pixmaps && state.pixmaps.length ? state.pixmaps
                                                    : [newPixmap()];
    layers = state.layers && state.layers.length ? state.layers
                                                 : [newLayer(0)];
  } catch (e) { pixmaps = [newPixmap()]; layers = [newLayer(0)]; }
}

/* ------------------------------------------------------------------ */
/* pixmap / layer editors                                               */
/* ------------------------------------------------------------------ */

function newPixmap() {
  return { path: "noise", layers: "0", introduction_path: "",
           alteration_path: "", seek_time: "", repeat: 1 };
}

function newLayer(index) {
  // defaults mirror the reference client's layer template (master.js:31-53)
  return { index, classname: "moveref",
           mask_src: "", mask_dst: "", mask_alpha: "",
           transparent_pixels_can_move: false,
           pixels_can_move_to_empty_spot: true,
           pixels_can_move_to_filled_spot: true,
           moving_pixels_leave_empty_spot: false,
           reset_mode: "off", reset_mask: "",
           reset_random_factor: 0.1, reset_constant_step: 1,
           reset_linear_factor: 0.1, reset_source: false,
           introduce_pixels_on_empty_spots: true,
           introduce_pixels_on_filled_spots: true,
           introduce_moving_pixels: true,
           introduce_unmoving_pixels: true,
           introduce_once: false,
           introduce_on_all_filled_spots: false,
           introduce_on_all_empty_spots: false };
}

function renderPixmaps() {
  const host = $("pixmaps");
  host.innerHTML = "";
  pixmaps.forEach((p, i) => {
    const div = document.createElement("div");
    div.className = "item";
    div.innerHTML = `
      <div class="row">
        <label>Source <input data-k="path" placeholder="image/video path, color:red, noise…"></label>
        <button class="mini" data-browse title="browse">&#128193;</button>
        <button class="mini" data-preview title="preview">&#128065;</button>
        <label>Layers <input data-k="layers" size="4" placeholder="0,1"></label>
        <button class="mini danger" data-del>&times;</button>
      </div>
      <div class="row">
        <label>Introduction <input data-k="introduction_path" placeholder="mask DSL"></label>
        <label>Alteration <input data-k="alteration_path" placeholder="overlay PNG"></label>
        <label>Seek <input data-k="seek_time" size="8"></label>
        <label>Repeat <input data-k="repeat" type="number" min="0" size="3"></label>
      </div>`;
    for (const input of div.querySelectorAll("[data-k]")) {
      input.value = p[input.dataset.k];
      input.addEventListener("input", () => {
        p[input.dataset.k] = input.value;
        saveState();
      });
    }
    div.querySelector("[data-browse]").addEventListener("click", () =>
      requestFile("OPEN", `pixmap_${i}`));
    div.querySelector("[data-preview]").addEventListener("click", () =>
      showMedia(p.path));
    div.querySelector("[data-del]").addEventListener("click", () => {
      pixmaps.splice(i, 1);
      renderPixmaps();
      saveState();
    });
    host.appendChild(div);
  });
  $("add_pixmap").disabled = pixmaps.length >= MAX_PIXMAPS;
}

function renderLayers() {
  const host = $("layers");
  host.innerHTML = "";
  layers.forEach((layer, i) => {
    const div = document.createElement("div");
    div.className = "item";
    // collapsible movement/reset/introduction groups mirror the reference
    // client's details panes (master.js movement/introduction/resetDetails)
    div.innerHTML = `
      <div class="row">
        <label>Index <input data-k="index" type="number" size="2"></label>
        <label>Class
          <select data-k="classname">
            <option>moveref</option><option>introduction</option>
            <option>static</option><option>sum</option>
          </select></label>
        <label>Alpha mask <input data-k="mask_alpha" placeholder="mask DSL"></label>
        <button class="mini danger" data-del>&times;</button>
      </div>
      <details><summary>Movement</summary>
        <div class="row">
          <label>Src mask <input data-k="mask_src" placeholder="mask DSL"></label>
          <label>Dst mask <input data-k="mask_dst" placeholder="mask DSL"></label>
        </div>
        <div class="row">
          <label><input data-k="transparent_pixels_can_move" type="checkbox"> transparent move</label>
          <label><input data-k="pixels_can_move_to_empty_spot" type="checkbox"> to empty</label>
          <label><input data-k="pixels_can_move_to_filled_spot" type="checkbox"> to filled</label>
          <label><input data-k="moving_pixels_leave_empty_spot" type="checkbox"> leave empty</label>
        </div>
      </details>
      <details><summary>Reset</summary>
        <div class="row">
          <label>Mode
            <select data-k="reset_mode">
              <option>off</option><option>random</option>
              <option>constant</option><option>linear</option>
            </select></label>
          <label>Mask <input data-k="reset_mask" placeholder="mask DSL"></label>
          <label><input data-k="reset_source" type="checkbox"> reset source</label>
        </div>
        <div class="row">
          <label>Random <input data-k="reset_random_factor" type="number" step="0.01" size="5"></label>
          <label>Constant <input data-k="reset_constant_step" type="number" step="0.1" size="5"></label>
          <label>Linear <input data-k="reset_linear_factor" type="number" step="0.01" size="5"></label>
        </div>
      </details>
      <details><summary>Introduction</summary>
        <div class="row">
          <label><input data-k="introduce_pixels_on_empty_spots" type="checkbox"> on empty</label>
          <label><input data-k="introduce_pixels_on_filled_spots" type="checkbox"> on filled</label>
          <label><input data-k="introduce_moving_pixels" type="checkbox"> moving</label>
          <label><input data-k="introduce_unmoving_pixels" type="checkbox"> unmoving</label>
        </div>
        <div class="row">
          <label><input data-k="introduce_once" type="checkbox"> once</label>
          <label><input data-k="introduce_on_all_filled_spots" type="checkbox"> force all filled</label>
          <label><input data-k="introduce_on_all_empty_spots" type="checkbox"> force all empty</label>
        </div>
      </details>`;
    for (const input of div.querySelectorAll("[data-k]")) {
      const key = input.dataset.k;
      if (input.type === "checkbox") input.checked = !!layer[key];
      else input.value = layer[key];
      input.addEventListener("input", () => {
        layer[key] = input.type === "checkbox" ? input.checked : input.value;
        saveState();
      });
    }
    div.querySelector("[data-del]").addEventListener("click", () => {
      layers.splice(i, 1);
      renderLayers();
      saveState();
    });
    host.appendChild(div);
  });
}

/* ------------------------------------------------------------------ */
/* config assembly (must mirror Config.fromdict keys)                  */
/* ------------------------------------------------------------------ */

function buildConfig() {
  const value = (id) => $(id).value.trim() || null;
  const config = {
    flow_path: value("flow_path"),
    direction: $("direction").value,
    use_mvs: $("use_mvs").checked,
    cv_config: value("cv_config_path") || { method: $("method").value },
    seek_time: value("seek_time"),
    duration_time: value("duration_time"),
    repeat: parseInt($("repeat").value || "1", 10),
    flow_filters: value("flow_filters"),
    mask_path: value("mask_path"),
    kernel_path: value("kernel_path"),
    lock_mode: $("lock_mode").value || null,
    lock_expr: value("lock_expr"),
    compositor_background: value("background") || "#ffffff",
    output_path: value("output_path"),
    vcodec: value("vcodec") || "h264",
    view_flow: $("view_flow").checked,
    view_flow_magnitude: $("view_flow_magnitude").checked,
    render_scale: parseFloat($("render_scale").value || "1"),
    render_colors: value("render_colors"),
    render_binary: $("render_binary").checked,
    pixmap_sources: pixmaps.map((p) => ({
      path: p.path,
      layers: String(p.layers).split(",").map(s => parseInt(s, 10))
                 .filter(n => !isNaN(n)),
      introduction_path: p.introduction_path || null,
      alteration_path: p.alteration_path || null,
      seek_time: p.seek_time || null,
      repeat: parseInt(p.repeat || "1", 10),
    })),
    layers: layers.slice(0, MAX_LAYERS).map((l) => ({
      index: parseInt(l.index, 10),
      classname: l.classname,
      mask_src: l.mask_src || null,
      mask_dst: l.mask_dst || null,
      mask_alpha: l.mask_alpha || null,
      transparent_pixels_can_move: !!l.transparent_pixels_can_move,
      pixels_can_move_to_empty_spot: !!l.pixels_can_move_to_empty_spot,
      pixels_can_move_to_filled_spot: !!l.pixels_can_move_to_filled_spot,
      moving_pixels_leave_empty_spot: !!l.moving_pixels_leave_empty_spot,
      reset_mode: l.reset_mode,
      reset_mask: l.reset_mask || null,
      reset_random_factor: parseFloat(l.reset_random_factor),
      reset_constant_step: parseFloat(l.reset_constant_step),
      reset_linear_factor: parseFloat(l.reset_linear_factor),
      reset_source: !!l.reset_source,
      introduce_pixels_on_empty_spots: !!l.introduce_pixels_on_empty_spots,
      introduce_pixels_on_filled_spots: !!l.introduce_pixels_on_filled_spots,
      introduce_moving_pixels: !!l.introduce_moving_pixels,
      introduce_unmoving_pixels: !!l.introduce_unmoving_pixels,
      introduce_once: !!l.introduce_once,
      introduce_on_all_filled_spots: !!l.introduce_on_all_filled_spots,
      introduce_on_all_empty_spots: !!l.introduce_on_all_empty_spots,
    })),
  };
  const seed = value("seed");
  if (seed !== null) config.seed = parseInt(seed, 10);
  const batch = value("batch_frames");
  if (batch !== null) config.batch_frames = parseInt(batch, 10);
  const mesh = value("mesh");
  if (mesh !== null) config.mesh = mesh;
  const halo = value("halo");
  if (halo !== null) config.halo = parseInt(halo, 10);
  return config;
}

/* ------------------------------------------------------------------ */
/* websocket client with reconnect                                      */
/* ------------------------------------------------------------------ */

async function connect() {
  const badge = $("connection");
  try {
    const port = await (await fetch("/wss")).text();
    ws = new WebSocket(`ws://${location.hostname}:${port.trim()}`);
    ws.onopen = () => { badge.textContent = "connected";
                        badge.className = "badge ok";
                        /* resync job state after a page reload (reference
                           master.js:524 sends RELOAD on open) */
                        ws.send("RELOAD"); };
    ws.onclose = () => { badge.textContent = "disconnected";
                         badge.className = "badge err";
                         setTimeout(connect, 2000); };
    ws.onmessage = (event) => onMessage(event.data);
  } catch (e) {
    badge.textContent = "server unreachable";
    badge.className = "badge err";
    setTimeout(connect, 2000);
  }
}

function applyConfig(config) {
  /* inverse of buildConfig: populate the editor from a Config JSON
     (the same files the CLI writes as <output>.config.json) */
  const set = (id, value) => {
    const el = $(id);
    if (!el || value === null || value === undefined) return;
    if (el.type === "checkbox") el.checked = !!value;
    else el.value = value;
  };
  set("flow_path", config.flow_path);
  // Config.fromdict defaults an absent direction to "forward"
  if (config.direction !== undefined && config.direction !== null) {
    set("direction", config.direction === 1
        || config.direction === "backward" ? "backward" : "forward");
  } else {
    set("direction", "forward");
  }
  set("use_mvs", config.use_mvs);
  if (config.cv_config && typeof config.cv_config === "object") {
    set("method", config.cv_config.method);
  } else {
    set("cv_config_path", config.cv_config);
  }
  set("seek_time", config.seek_time);
  set("duration_time", config.duration_time);
  set("repeat", config.repeat);
  set("flow_filters", config.flow_filters);
  set("mask_path", config.mask_path);
  set("kernel_path", config.kernel_path);
  set("lock_mode", config.lock_mode === 1 || config.lock_mode === "skip"
      ? "skip" : (config.lock_expr ? "stay" : ""));
  set("lock_expr", config.lock_expr);
  set("background", config.compositor_background);
  set("output_path", Array.isArray(config.output_path)
      ? config.output_path[0] : config.output_path);
  set("view_flow", config.view_flow);
  set("view_flow_magnitude", config.view_flow_magnitude);
  set("vcodec", config.vcodec);
  set("render_scale", config.render_scale);
  set("render_colors", Array.isArray(config.render_colors)
      ? config.render_colors.join(",") : config.render_colors);
  set("render_binary", config.render_binary);
  set("seed", config.seed);
  set("batch_frames", config.batch_frames);
  set("mesh", config.mesh);
  set("halo", config.halo);
  pixmaps = (config.pixmap_sources || []).slice(0, MAX_PIXMAPS).map(p => ({
    path: p.path ?? "noise",
    layers: (p.layers || [0]).join(","),
    introduction_path: p.introduction_path || "",
    alteration_path: p.alteration_path || "",
    seek_time: p.seek_time || "",
    repeat: p.repeat ?? 1,
  }));
  if (!pixmaps.length) pixmaps = [newPixmap()];
  layers = (config.layers || []).slice(0, MAX_LAYERS).map(l => ({
    ...newLayer(l.index ?? 0),
    classname: l.classname || "moveref",
    mask_src: l.mask_src || "",
    mask_dst: l.mask_dst || "",
    mask_alpha: l.mask_alpha || "",
    transparent_pixels_can_move: !!l.transparent_pixels_can_move,
    pixels_can_move_to_empty_spot: l.pixels_can_move_to_empty_spot ?? true,
    pixels_can_move_to_filled_spot: l.pixels_can_move_to_filled_spot ?? true,
    moving_pixels_leave_empty_spot: !!l.moving_pixels_leave_empty_spot,
    reset_mode: l.reset_mode || "off",
    reset_mask: l.reset_mask || "",
    reset_random_factor: l.reset_random_factor ?? 0.1,
    reset_constant_step: l.reset_constant_step ?? 1,
    reset_linear_factor: l.reset_linear_factor ?? 0.1,
    reset_source: !!l.reset_source,
    introduce_pixels_on_empty_spots: l.introduce_pixels_on_empty_spots ?? true,
    introduce_pixels_on_filled_spots: l.introduce_pixels_on_filled_spots ?? true,
    introduce_moving_pixels: l.introduce_moving_pixels ?? true,
    introduce_unmoving_pixels: l.introduce_unmoving_pixels ?? true,
    introduce_once: !!l.introduce_once,
    introduce_on_all_filled_spots: !!l.introduce_on_all_filled_spots,
    introduce_on_all_empty_spots: !!l.introduce_on_all_empty_spots,
  }));
  if (!layers.length) layers = [newLayer(0)];
  renderPixmaps();
  renderLayers();
  saveState();
}

/* ------------------------------------------------------------------ */
/* server file dialogs + media preview (scrubbing via /media ranges)    */
/* ------------------------------------------------------------------ */

function requestFile(kind, key) {
  if (!ws || ws.readyState !== WebSocket.OPEN) {
    $("status").textContent = "not connected";
    return;
  }
  ws.send(`FILE_${kind} ${key}`);
}

function applyFile(key, path) {
  if (key.startsWith("pixmap_")) {
    const i = parseInt(key.slice(7), 10);
    if (pixmaps[i]) {
      pixmaps[i].path = path;
      renderPixmaps();
      saveState();
    }
  } else {
    const el = $(key);
    if (el) {
      el.value = path;
      el.dispatchEvent(new Event("input"));
    }
  }
  if (VIDEO_EXT.test(path) || IMAGE_EXT.test(path)) showMedia(path);
}

function showMedia(path) {
  path = (path || "").trim();
  const video = $("media_video");
  const image = $("media_image");
  const note = $("media_note");
  video.style.display = "none";
  image.style.display = "none";
  if (VIDEO_EXT.test(path)) {
    // the /media endpoint answers HTTP range requests, so the browser's
    // native controls can scrub the file
    video.src = "/media?path=" + encodeURIComponent(path);
    video.style.display = "block";
    note.textContent = path;
  } else if (IMAGE_EXT.test(path)) {
    image.src = "/media?path=" + encodeURIComponent(path);
    image.style.display = "block";
    note.textContent = path;
  } else {
    note.textContent = path
      ? `no preview for "${path}" (generated source?)` : "";
  }
}

function onMessage(message) {
  const status = $("status");
  if (message.startsWith("FILE ")) {
    const rest = message.slice(5);
    const space = rest.indexOf(" ");
    if (space > 0) applyFile(rest.slice(0, space), rest.slice(space + 1));
    return;
  }
  if (message.startsWith("STATUS ")) {
    const s = JSON.parse(message.slice(7));
    if (s.error) { status.textContent = `error: ${s.error}`; return; }
    const pct = s.total ? Math.round(100 * s.cursor / s.total) : null;
    $("progress").style.width = (pct ?? 30) + "%";
    status.textContent = `frame ${s.cursor}` +
      (s.total ? ` / ${s.total}` : "") +
      ` — ${s.elapsed.toFixed(1)}s`;
  } else if (message.startsWith("PREVIEW ")) {
    $("preview").src = message.slice(8).trim() + "?" + Date.now();
  } else if (message.startsWith("DONE")) {
    $("generate").disabled = false;
    $("interrupt").disabled = true;
    $("progress").style.width = "100%";
    status.textContent = "done " + message.slice(4).trim();
  } else if (message.startsWith("CANCEL")) {
    $("generate").disabled = false;
    $("interrupt").disabled = true;
    status.textContent = "cancelled";
  } else if (message.startsWith("RELOAD ")) {
    /* server's answer to our onopen RELOAD: adopt the current job state */
    const state = JSON.parse(message.slice(7));
    $("generate").disabled = !!state.ongoing;
    $("interrupt").disabled = !state.ongoing;
    if (state.ongoing && state.previewUrl) {
      $("preview").src = state.previewUrl + "?" + Date.now();
      status.textContent = "job running";
    } else if (state.outputFile) {
      status.textContent = "done " + state.outputFile;
    }
  } else if (message.startsWith("ERROR")) {
    $("generate").disabled = false;
    $("interrupt").disabled = true;
    status.textContent = message;
  }
}

/* ------------------------------------------------------------------ */
/* wiring                                                               */
/* ------------------------------------------------------------------ */

/* ------------------------------------------------------------------ */
/* mask builder: compose DSL rules with a live preview                  */
/* ------------------------------------------------------------------ */

let maskTarget = null;

function evalMask(rule, w, h) {
  // client-side mirror of the mask DSL for previewing (utils/masks.py)
  const out = new Float32Array(w * h);
  const inv = rule.endsWith(":inv");
  if (inv) rule = rule.slice(0, -4);
  const [name, ...args] = rule.split(":");
  const dim = (s, parent) => !s ? 0 : s.endsWith("%")
      ? Math.floor(parseFloat(s) / 100 * parent) : parseInt(s, 10);
  const set = (cond) => {
    for (let i = 0; i < h; i++)
      for (let j = 0; j < w; j++)
        out[i * w + j] = cond(i, j) ? 1 : 0;
  };
  if (name === "ones") set(() => true);
  else if (name === "zeros") set(() => false);
  else if (name === "random") { for (let k = 0; k < out.length; k++) out[k] = Math.random(); }
  else if (name.startsWith("border")) {
    let t = 0, r = 0, b = 0, l = 0;
    if (name === "border") {
      const p = args.map((a, i) => dim(a, i % 2 === 0 ? h : w));
      if (p.length === 1) t = r = b = l = p[0];
      else if (p.length === 2) { t = b = p[0]; r = l = p[1]; }
      else if (p.length === 4) [t, r, b, l] = p;
    } else if (name === "border-top") t = dim(args[0], h);
    else if (name === "border-right") r = dim(args[0], w);
    else if (name === "border-bottom") b = dim(args[0], h);
    else if (name === "border-left") l = dim(args[0], w);
    set((i, j) => i < t || j >= w - r || i >= h - b || j < l);
  } else if (name === "hline") {
    const size = dim(args[0], h), i0 = Math.floor((h - size) / 2);
    set((i) => i >= i0 && i < i0 + size);
  } else if (name === "vline") {
    const size = dim(args[0], w), j0 = Math.floor((w - size) / 2);
    set((i, j) => j >= j0 && j < j0 + size);
  } else if (name === "circle") {
    const rad = dim(args[0], Math.min(w, h));
    set((i, j) => (i - (h >> 1)) ** 2 + (j - (w >> 1)) ** 2 < rad * rad);
  } else if (name === "rect") {
    const rw = dim(args[0], w), rh = dim(args[1] || args[0], h);
    set((i, j) => Math.abs(i - (h >> 1)) < (rh >> 1) + (rh % 2)
               && Math.abs(j - (w >> 1)) < (rw >> 1) + (rw % 2));
  } else if (name === "grid") {
    const rows = parseInt(args[0] || "2"), cols = parseInt(args[1] || "2"),
          rad = parseInt(args[2] || "4");
    const ch = Math.floor(h / rows), cw = Math.floor(w / cols);
    set((i, j) => {
      const ci = (Math.floor(i / ch) + 0.5) * ch, cj = (Math.floor(j / cw) + 0.5) * cw;
      return (i - ci) ** 2 + (j - cj) ** 2 < rad * rad;
    });
  }
  if (inv) for (let k = 0; k < out.length; k++) out[k] = 1 - out[k];
  return out;
}

function updateMaskPreview() {
  const type = $("mb_type").value;
  const params = $("mb_params").value.trim();
  let rule = params && !["ones", "zeros", "random"].includes(type)
      ? `${type}:${params}` : type;
  if ($("mb_inv").checked) rule += ":inv";
  $("mb_rule").textContent = rule;
  const canvas = $("mb_preview");
  const ctx = canvas.getContext("2d");
  const { width: w, height: h } = canvas;
  try {
    const mask = evalMask(rule, w, h);
    const img = ctx.createImageData(w, h);
    for (let k = 0; k < w * h; k++) {
      const v = Math.round(255 * mask[k]);
      img.data[4 * k] = img.data[4 * k + 1] = img.data[4 * k + 2] = v;
      img.data[4 * k + 3] = 255;
    }
    ctx.putImageData(img, 0, 0);
  } catch (e) { ctx.clearRect(0, 0, w, h); }
  return rule;
}

function setupMaskBuilder() {
  document.body.addEventListener("focusin", (ev) => {
    if (ev.target.matches("input.maskable, [data-k=introduction_path], #mask_path, [data-k=mask_alpha]"))
      maskTarget = ev.target;
  });
  $("open_mask_builder").addEventListener("click", () => {
    $("mask_builder").showModal();
    updateMaskPreview();
  });
  for (const id of ["mb_type", "mb_params", "mb_inv"])
    $(id).addEventListener("input", updateMaskPreview);
  $("mb_insert").addEventListener("click", () => {
    const rule = updateMaskPreview();
    const target = maskTarget || $("mask_path");
    target.value = rule;
    target.dispatchEvent(new Event("input"));
    $("mask_builder").close();
  });
  $("mb_close").addEventListener("click", () => $("mask_builder").close());
}

window.addEventListener("DOMContentLoaded", () => {
  loadState();
  setupMaskBuilder();
  renderPixmaps();
  renderLayers();
  for (const el of document.querySelectorAll("input, select")) {
    el.addEventListener("input", saveState);
  }
  $("add_pixmap").addEventListener("click", () => {
    if (pixmaps.length >= MAX_PIXMAPS) return;
    pixmaps.push(newPixmap());
    renderPixmaps();
    saveState();
  });
  $("browse_flow").addEventListener("click", () =>
    requestFile("OPEN", "flow_path"));
  $("browse_output").addEventListener("click", () =>
    requestFile("SAVE", "output_path"));
  $("browse_kernel").addEventListener("click", () =>
    requestFile("OPEN", "kernel_path"));
  $("preview_flow").addEventListener("click", () =>
    showMedia($("flow_path").value));
  $("flow_path").addEventListener("change", () =>
    showMedia($("flow_path").value));
  $("add_layer").addEventListener("click", () => {
    if (layers.length >= MAX_LAYERS) return;
    layers.push(newLayer(layers.length));
    renderLayers();
    saveState();
  });
  $("generate").addEventListener("click", () => {
    if (!ws || ws.readyState !== WebSocket.OPEN) return;
    const config = buildConfig();
    if (!config.flow_path) { $("status").textContent = "flow source required"; return; }
    ws.send("GENERATE " + JSON.stringify(config));
    $("generate").disabled = true;
    $("interrupt").disabled = false;
    $("progress").style.width = "0%";
    $("status").textContent = "starting…";
  });
  $("interrupt").addEventListener("click", () => {
    if (ws && ws.readyState === WebSocket.OPEN) ws.send("INTERRUPT");
  });
  $("reload").addEventListener("click", () => {
    /* page reload; the fresh websocket's onopen RELOAD resyncs job state */
    location.reload();
  });
  $("export_json").addEventListener("click", () => {
    const blob = new Blob([JSON.stringify(buildConfig(), null, 2)],
                          { type: "application/json" });
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = "transflow-config.json";
    a.click();
    URL.revokeObjectURL(a.href);
  });
  // the label wraps the hidden input: native activation opens the picker
  $("import_json").addEventListener("change", async (event) => {
    const file = event.target.files[0];
    if (!file) return;
    try {
      applyConfig(JSON.parse(await file.text()));
    } catch (e) {
      $("status").textContent = "bad config file: " + e.message;
    }
  });
  connect();
});
