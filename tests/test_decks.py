"""Native input decks: namoptions / prof.inp / fort.4 readers and the
CLI precedence chain (defaults < decks < conf JSON < explicit flags)."""

import json
import os
import textwrap

import numpy as np

from sp_coupler.config import SPConfig
from sp_coupler.utils import decks

NAMOPTIONS = textwrap.dedent("""\
    &RUN
    iexpnr     =  001
    lwarmstart =  .false.
    trestart   =  80700
    ladaptive  =  .true.
    courant    = .7
    peclet     = .1
    /

    &DOMAIN
    itot       =  32
    jtot       =  16
    kmax       =  48
    xsize      =  6400.
    ysize      =  3200.
    /

    &DYNAMICS
    iadv_mom    =  62
    iadv_thl    =  52
    iadv_qt     =  52
    iadv_sv     =  0,52
    /

    &NAMSUBGRID
    lsmagorinsky = .true.
    /
    """)

FORT4 = textwrap.dedent("""\
    &NAMDIM
    NPROMA=-8,
    /
    &NAMRIP
     TSTEP=450.000000,
    /
    """)


def write_case(tmp_path):
    les = tmp_path / "dales-input"
    les.mkdir()
    (les / "namoptions.001").write_text(NAMOPTIONS)
    z = np.arange(48) * 50.0 + 25.0
    rows = ["# test case", "# z thl qt u v tke"]
    for k in range(48):
        rows.append("%9.3f %9.3f %8.5f %8.3f %8.3f %6.3f"
                    % (z[k], 298.0 + 0.006 * z[k], 0.014, -8.0, -2.0, 1.0))
    (les / "prof.inp.001").write_text("\n".join(rows) + "\n")
    gcm = tmp_path / "oifs-input"
    gcm.mkdir()
    (gcm / "fort.4").write_text(FORT4)
    return str(les), str(gcm)


def test_parse_namelist():
    nml = decks.parse_namelist(NAMOPTIONS)
    assert nml["DOMAIN"]["itot"] == 32
    assert nml["RUN"]["ladaptive"] is True
    assert nml["RUN"]["courant"] == 0.7
    assert nml["DYNAMICS"]["iadv_sv"] == [0, 52]
    assert nml["NAMSUBGRID"]["lsmagorinsky"] is True


def test_dales_overrides(tmp_path):
    les, _ = write_case(tmp_path)
    out = decks.dales_overrides(les)
    assert out["les_itot"] == 32 and out["les_jtot"] == 16
    assert out["les_ktot"] == 48
    assert out["les_xsize"] == 6400.0 and out["les_ysize"] == 3200.0
    assert out["les_cfl"] == 0.7
    assert out["les_advection"] == "hybrid52"
    assert out["les_subgrid"] == "smagorinsky"
    assert out["les_dz"] == 50.0
    assert out["_trestart"] == 80700.0


def test_oifs_overrides(tmp_path):
    _, gcm = write_case(tmp_path)
    out = decks.oifs_overrides(gcm)
    assert out["gcm_dt"] == 450.0


def test_apply_decks(tmp_path):
    les, gcm = write_case(tmp_path)
    cfg = SPConfig(les_input_dir=les, gcm_input_dir=gcm)
    cfg2 = decks.apply_decks(cfg)
    assert cfg2.les_itot == 32 and cfg2.gcm_dt == 450.0
    # trestart 80700 s / 450 s = 179 steps between checkpoints
    assert cfg2.restart_steps == 179


def test_prof_reader(tmp_path):
    les, _ = write_case(tmp_path)
    prof = decks.read_dales_prof(les)
    assert prof["z"][0] == 25.0
    assert np.allclose(prof["qt"], 0.014)
    assert np.allclose(prof["e12"], 1.0)


def test_cli_precedence(tmp_path):
    """decks < conf JSON < explicit CLI flag."""
    import spmaster
    les, gcm = write_case(tmp_path)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"les_jtot": 8, "gcm_steps": 3}))
    parser = spmaster.build_parser(SPConfig())
    # replicate main()'s config resolution
    args = parser.parse_args([
        "--lesdir", les, "--gcmdir", gcm, "--conf", str(conf),
        "--steps", "5"])
    cfg = SPConfig().replace(les_input_dir=les, gcm_input_dir=gcm)
    cfg = decks.apply_decks(cfg)
    from sp_coupler.config import read_config
    cfg = read_config(args.conf, base=cfg)
    overrides = {k: v for k, v in vars(args).items()
                 if k in SPConfig.__dataclass_fields__
                 and v != parser.get_default(k)}
    cfg = cfg.replace(**overrides)
    assert cfg.les_itot == 32        # from deck
    assert cfg.les_jtot == 8         # conf overrides deck
    assert cfg.gcm_dt == 450.0       # from deck
    assert cfg.gcm_steps == 5        # explicit flag overrides conf


def test_driver_cold_start_from_prof(tmp_path):
    """init_les_state=False + a DALES deck: the fleet initializes from
    prof.inp (the reference LES self-initializes from its deck)."""
    from sp_coupler.runtime.driver import SPRunner
    from sp_coupler.utils import geometry
    les, _ = write_case(tmp_path)
    cfg = SPConfig(gcm_type="sptpu", les_type="sptpu",
                   gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
                   les_itot=16, les_jtot=16, les_ktot=24,
                   les_xsize=3200.0, les_ysize=3200.0, les_dz=100.0,
                   les_dt=5.0, init_les_state=False, les_input_dir=les,
                   output_dir=str(tmp_path / "out"))
    r = SPRunner(cfg, [geometry.Point((300.0, 15.0))])
    r.initialize()
    prof = r.fleet.get_profiles()
    thl = np.asarray(prof["THL"])
    # prof.inp thl = 298 + 0.006 z, interpolated onto the 24x100 m grid
    zf = np.asarray(r.fleet.get_zf())
    ref = np.interp(zf, np.arange(48) * 50.0 + 25.0,
                    298.0 + 0.006 * (np.arange(48) * 50.0 + 25.0))
    assert np.allclose(thl[0], ref, atol=0.2)
    r.run(1)
    r.finalize(save_restart=False)
