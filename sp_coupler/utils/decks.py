"""Native model input decks: DALES namoptions / prof.inp, OpenIFS fort.4.

The reference forwards its input directories straight to the Fortran
codes, which configure themselves from these decks
(/root/reference/splib/modfac.py:40-61, 76-93; dales-input/namoptions.001;
oifs-input/fort.4). Here the decks configure the native models: a
``--lesdir`` with a ``namoptions.<iexpnr>`` sets the LES grid, advection
scheme, subgrid model, CFL/Peclet targets and restart cadence, and a
``--gcmdir`` with a ``fort.4`` sets the GCM time step — so a reference
input directory is usable as-is.

Precedence (applied by spmaster.main): dataclass defaults < input decks
< ``--conf`` JSON < explicitly-given CLI flags.
"""

import logging
import os

import numpy as np

log = logging.getLogger(__name__)

_BOOL = {".true.": True, ".t.": True, "t": True,
         ".false.": False, ".f.": False, "f": False}


def _parse_value(tok):
    t = tok.strip().rstrip(",").strip()
    if not t:
        return None
    low = t.lower()
    if low in _BOOL:
        return _BOOL[low]
    if (t[0] == t[-1] == "'") or (t[0] == t[-1] == '"'):
        return t[1:-1]
    try:
        return int(t)
    except ValueError:
        pass
    try:
        # Fortran double-precision exponents: 1.d0 / 1.D0
        return float(low.replace("d", "e"))
    except ValueError:
        return t


def parse_namelist(text):
    """Fortran namelist text -> {GROUP: {key: value-or-list}}.

    Handles &GROUP ... / blocks, ! comments, comma-separated value lists,
    and the derived-type keys OpenIFS uses (YQ_NL%LGP=true) verbatim.
    """
    groups = {}
    current = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            current = line[1:].strip().upper()
            groups.setdefault(current, {})
            continue
        if line.startswith("/"):
            current = None
            continue
        if current is None or "=" not in line:
            continue
        key, _, rhs = line.partition("=")
        vals = [v for v in (_parse_value(x) for x in rhs.split(","))
                if v is not None]
        if not vals:
            continue
        groups[current][key.strip().lower()] = (
            vals[0] if len(vals) == 1 else vals)
    return groups


def find_namoptions(inputdir, exp="001"):
    """The DALES deck path in inputdir, or None."""
    for name in ("namoptions.%s" % exp, "namoptions.001", "namoptions"):
        p = os.path.join(inputdir, name)
        if os.path.exists(p):
            return p
    return None


_IADV = {2: "cd2", 52: "hybrid52", 62: "hybrid52", 5: "hybrid52"}


def dales_overrides(inputdir, exp="001"):
    """SPConfig override dict from a DALES input directory (or {})."""
    path = find_namoptions(inputdir, exp)
    if path is None:
        return {}
    with open(path) as f:
        nml = parse_namelist(f.read())
    out = {}
    dom = nml.get("DOMAIN", {})
    if "itot" in dom:
        out["les_itot"] = int(dom["itot"])
    if "jtot" in dom:
        out["les_jtot"] = int(dom["jtot"])
    if "kmax" in dom:
        out["les_ktot"] = int(dom["kmax"])
    if "xsize" in dom:
        out["les_xsize"] = float(dom["xsize"])
    if "ysize" in dom:
        out["les_ysize"] = float(dom["ysize"])
    run = nml.get("RUN", {})
    if "courant" in run:
        out["les_cfl"] = float(run["courant"])
    if "peclet" in run:
        out["les_peclet"] = float(run["peclet"])
    if "dtmax" in run:
        out["les_dt"] = float(run["dtmax"])
    if "ladaptive" in run and not run["ladaptive"]:
        # fixed-substep mode: substeps per GCM step derived by the driver
        # from les_dt (dtmax) when les_nsubsteps is not set explicitly
        out["_ladaptive"] = False
    if "trestart" in run:
        out["_trestart"] = float(run["trestart"])
    dyn = nml.get("DYNAMICS", {})
    iadv = dyn.get("iadv_thl", dyn.get("iadv_qt"))
    if iadv is not None and int(iadv) in _IADV:
        out["les_advection"] = _IADV[int(iadv)]
    sub = nml.get("NAMSUBGRID", {})
    if sub.get("lsmagorinsky"):
        out["les_subgrid"] = "smagorinsky"
    # per-instance cross-section statistics (reference README.md:108-111)
    cs = nml.get("NAMCROSSSECTION", {})
    if cs.get("lcross"):
        out["les_cross"] = True
        ch = cs.get("crossheight")
        if ch is not None:
            if not isinstance(ch, (list, tuple)):
                ch = [ch]
            out["les_cross_heights"] = tuple(int(x) for x in ch)
        if "dtav" in cs:
            out["les_cross_dtav"] = float(cs["dtav"])
    # vertical grid spacing from the initial-profile heights
    prof = read_dales_prof(inputdir, exp)
    if prof is not None:
        z = prof["z"]
        dz = np.diff(z)
        if len(dz) and np.allclose(dz, dz[0], rtol=1e-6):
            out["les_dz"] = float(dz[0])
        elif len(dz):
            log.warning("prof.inp has a stretched z-grid (dz %.1f..%.1f m);"
                        " using the lowest spacing (uniform-grid solver)",
                        dz.min(), dz.max())
            out["les_dz"] = float(dz[0])
    log.info("DALES deck %s: %s", path,
             {k: v for k, v in out.items() if not k.startswith("_")})
    return out


def read_dales_prof(inputdir, exp="001"):
    """prof.inp columns {z, thl, qt, u, v, e12} (or None).

    Format (dales-input/prof.inp.001): two header lines, then
    height, th_l, q_t, u, v, TKE columns.
    """
    for name in ("prof.inp.%s" % exp, "prof.inp.001", "prof.inp"):
        path = os.path.join(inputdir, name)
        if os.path.exists(path):
            break
    else:
        return None
    data = np.loadtxt(path, skiprows=2)
    if data.ndim != 2 or data.shape[1] < 5:
        return None
    out = {"z": data[:, 0], "thl": data[:, 1], "qt": data[:, 2],
           "u": data[:, 3], "v": data[:, 4]}
    if data.shape[1] > 5:
        out["e12"] = np.sqrt(np.maximum(data[:, 5], 0.0))
    return out


def oifs_overrides(inputdir):
    """SPConfig override dict from an OpenIFS input directory (or {})."""
    path = os.path.join(inputdir, "fort.4")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        nml = parse_namelist(f.read())
    out = {}
    for group in nml.values():
        if "tstep" in group:
            out["gcm_dt"] = float(group["tstep"])
        if "nsmax" in group:
            out["gcm_truncation"] = int(group["nsmax"])
    log.info("OpenIFS deck %s: %s", path, out)
    return out


def apply_decks(cfg):
    """New SPConfig with deck-derived settings from the input dirs."""
    over = {}
    if cfg.les_input_dir and os.path.isdir(cfg.les_input_dir):
        over.update(dales_overrides(cfg.les_input_dir, cfg.les_exp_name))
    if cfg.gcm_input_dir and os.path.isdir(cfg.gcm_input_dir):
        over.update(oifs_overrides(cfg.gcm_input_dir))
    trestart = over.pop("_trestart", None)
    if trestart and cfg.restart_steps == 0:
        dt = over.get("gcm_dt", cfg.gcm_dt)
        over["restart_steps"] = max(1, int(round(trestart / dt)))
    if over.pop("_ladaptive", True) is False and cfg.les_nsubsteps == 0:
        # DALES fixed-dt mode: substep count from dtmax over the GCM step
        dt_gcm = over.get("gcm_dt", cfg.gcm_dt)
        dt_les = over.get("les_dt", cfg.les_dt if cfg.les_dt > 0 else 15.0)
        over["les_nsubsteps"] = max(1, int(round(dt_gcm / dt_les)))
    return cfg.replace(**over) if over else cfg
