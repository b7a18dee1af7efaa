// EM-Spec M4L companion device logic (Ableton side of the
// live_state.json contract — reference docs/MAX-FOR-LIVE.md:56-60:
// the device monitors Live's Info View and writes
// {"state": "minimized"|"restored"} to the EM-Spec user-data dir).
//
// Runs inside a [js emspec_state.js] object in the Max patch
// (EM-Spec.maxpat in this directory).  Messages:
//   platform mac|pc      — which user-data layout to write
//   username <name>      — needed on pc for %APPDATA% expansion
//   userdir <path>       — explicit override of the state dir
//   bang                 — poll once (the patch banks a metro into this)
//   start / stop         — enable/disable the poller
//
// Outlets: 0 = status string for the device UI.

autowatch = 1;
inlets = 1;
outlets = 1;

var cfg = { platform: "mac", username: "", userdir: "" };
var running = true;
var last_state = "";

// Live's Info View in the Live Object Model: live_app view exposes
// is_view_visible(name).  The Info View's canonical name is "Help"
// in older LOM docs and "Info" in newer device examples — probe both
// once and remember which one answers.
var view_names = ["Info", "Help"];
var resolved_view = null;

function state_path() {
    if (cfg.userdir !== "") {
        return cfg.userdir + "/live_state.json";
    }
    if (cfg.platform === "pc") {
        return "C:/Users/" + cfg.username +
            "/AppData/Roaming/EM-Spec/live_state.json";
    }
    return "~/Library/Application Support/EM-Spec/live_state.json";
}

function platform(p) {
    cfg.platform = (p === "pc" || p === 1) ? "pc" : "mac";
    outlet(0, "platform: " + cfg.platform);
}

function username(n) { cfg.username = String(n); }

function userdir(d) { cfg.userdir = String(d); }

function start() { running = true; outlet(0, "Monitoring On"); }

function stop() { running = false; outlet(0, "Monitoring Off"); }

function info_view_visible() {
    var api = new LiveAPI("live_app view");
    if (!api) { return null; }
    if (resolved_view !== null) {
        return api.call("is_view_visible", resolved_view) > 0;
    }
    for (var i = 0; i < view_names.length; i++) {
        try {
            var v = api.call("is_view_visible", view_names[i]);
            if (v === 0 || v === 1) {
                resolved_view = view_names[i];
                return v > 0;
            }
        } catch (e) { /* name unknown to this Live version */ }
    }
    return null;
}

function write_state(state) {
    if (state === last_state) { return; }
    var f = new File(state_path(), "write");
    if (!f.isopen) {
        outlet(0, "cannot open " + state_path());
        return;
    }
    f.eof = 0;                                   // truncate
    f.writestring('{"state": "' + state + '"}');
    f.close();
    last_state = state;
    outlet(0, state);
}

function bang() {
    if (!running) { return; }
    var visible = info_view_visible();
    if (visible === null) {
        outlet(0, "Info View not observable in this Live version");
        return;
    }
    // Info View shown → EM-Spec restores; hidden → minimizes
    // (MAX-FOR-LIVE.md:17-19)
    write_state(visible ? "restored" : "minimized");
}
