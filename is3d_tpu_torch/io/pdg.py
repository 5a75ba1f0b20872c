"""PDG hadron-resonance lists.

Reimplements the reference's particle-data layer (reference:
src/cpp/readindata.cpp:1201-1716):

* the "conventional" urqmd/smash format: one header row per species
  (mcid name mass width gspin baryon strange charm bottom gisospin charge
  n_decays) followed by n_decays rows
  (mcid n_daughters branch_ratio d1..d5), with antibaryon entries
  auto-generated with sign-flipped quantum numbers and remapped daughters;
* the smash-box format: name mass width parity mcid... rows, with all
  quantum numbers decoded from the PDG Monte-Carlo id digits;
* quantum-statistics sign from baryon number parity
  (readindata.cpp:1544-1545);
* the chosen-particle sub-selection (emissionfunction.cpp:336-369).

Everything lands in a ParticleTable of numpy arrays (host metadata) from
which device-side species arrays are sliced per kernel launch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_DECAY_PART = 5


@dataclass
class ParticleTable:
    """SoA table of hadron species, in file order (antibaryons interleaved)."""

    mc_id: np.ndarray          # (N,) int64
    name: list
    mass: np.ndarray           # (N,) f64, GeV
    width: np.ndarray          # (N,) f64, GeV
    gspin: np.ndarray          # (N,) f64 spin degeneracy
    baryon: np.ndarray         # (N,) int
    strange: np.ndarray        # (N,) int
    charm: np.ndarray          # (N,) int
    bottom: np.ndarray         # (N,) int
    gisospin: np.ndarray       # (N,) int
    charge: np.ndarray         # (N,) int
    sign: np.ndarray           # (N,) int (+1 fermion, -1 boson)
    stable: np.ndarray         # (N,) bool
    # ragged decay info, per species: (n_channels, 2 + MAX_DECAY_PART)
    # columns: n_daughters, branch_ratio, d1..d5 (mc ids; 0 = none)
    decays_n: list = field(default_factory=list)         # list[int]
    decays_branch: list = field(default_factory=list)    # list[np.ndarray]
    decays_part: list = field(default_factory=list)      # list[np.ndarray (nch,5) int]
    # densities filled later by deltaf.compute_particle_densities
    equilibrium_density: np.ndarray = None
    bulk_density: np.ndarray = None
    diff_density: np.ndarray = None

    def __len__(self):
        return len(self.mc_id)

    def index_of_mcid(self, mcid: int) -> int:
        hits = np.nonzero(self.mc_id == mcid)[0]
        if len(hits) == 0:
            raise KeyError(f"mc_id {mcid} not in particle table")
        return int(hits[0])


def _tokens(path: str):
    with open(path) as f:
        return f.read().split()


def read_resonances_conventional(path: str) -> ParticleTable:
    """Parse the urqmd/smash 'conventional' PDG format with antibaryon
    mirroring (reference: src/cpp/readindata.cpp:1440-1567)."""
    toks = _tokens(path)
    pos = 0
    n_tok = len(toks)

    cols = {k: [] for k in ("mc_id", "name", "mass", "width", "gspin", "baryon",
                            "strange", "charm", "bottom", "gisospin", "charge")}
    stable, decays_n, decays_branch, decays_part = [], [], [], []

    def mirror_daughters(nch, branch, parts, table_mcids, parent_stable):
        """Antibaryon decay daughters: negate unless the daughter is its own
        antiparticle (baryon==charge==strange==0 in the table so far)."""
        out = parts.copy()
        for j in range(nch):
            for k in range(MAX_DECAY_PART):
                d = parts[j, k]
                if d == 0:
                    continue
                idx = table_mcids.get(d)
                if idx is None:
                    if not parent_stable and branch[j] > 1e-15:
                        raise ValueError(f"cannot find decay daughter {d} for antibaryon")
                    # stable parent's dummy self-decay: keep as is
                    continue
                b, q, s = (cols["baryon"][idx], cols["charge"][idx],
                           cols["strange"][idx])
                if not (b == 0 and q == 0 and s == 0):
                    out[j, k] = -d
        return out

    mcid_to_idx = {}

    while pos < n_tok:
        mc_id = int(toks[pos]); name = toks[pos + 1]
        mass = float(toks[pos + 2]); width = float(toks[pos + 3])
        gspin = float(toks[pos + 4]); baryon = int(toks[pos + 5])
        strange = int(toks[pos + 6]); charm = int(toks[pos + 7])
        bottom = int(toks[pos + 8]); gisospin = int(toks[pos + 9])
        charge = int(toks[pos + 10]); ndec = int(toks[pos + 11])
        pos += 12

        nch = ndec
        branch = np.zeros(nch)
        npart_ch = np.zeros(nch, dtype=np.int64)
        parts = np.zeros((nch, MAX_DECAY_PART), dtype=np.int64)
        for j in range(nch):
            # dummy mcid column, n_daughters, branch, 5 daughters
            npart_ch[j] = int(toks[pos + 1])
            branch[j] = float(toks[pos + 2])
            for k in range(MAX_DECAY_PART):
                parts[j, k] = int(toks[pos + 3 + k])
            pos += 8

        is_stable = bool(nch > 0 and npart_ch[0] == 1)

        for key, val in (("mc_id", mc_id), ("name", name), ("mass", mass),
                         ("width", width), ("gspin", gspin), ("baryon", baryon),
                         ("strange", strange), ("charm", charm), ("bottom", bottom),
                         ("gisospin", gisospin), ("charge", charge)):
            cols[key].append(val)
        stable.append(is_stable)
        decays_n.append(npart_ch)
        decays_branch.append(branch)
        decays_part.append(parts)
        mcid_to_idx[mc_id] = len(cols["mc_id"]) - 1

        if baryon > 0:
            # auto-generate the antibaryon (reference: readindata.cpp:1491-1536)
            anti_parts = mirror_daughters(nch, branch, parts, mcid_to_idx, is_stable)
            for key, val in (("mc_id", -mc_id), ("name", "Anti-baryon-" + name),
                             ("mass", mass), ("width", width), ("gspin", gspin),
                             ("baryon", -baryon), ("strange", -strange),
                             ("charm", -charm), ("bottom", -bottom),
                             ("gisospin", gisospin), ("charge", -charge)):
                cols[key].append(val)
            stable.append(is_stable)
            decays_n.append(npart_ch.copy())
            decays_branch.append(branch.copy())
            decays_part.append(anti_parts)
            mcid_to_idx[-mc_id] = len(cols["mc_id"]) - 1

    baryon_arr = np.asarray(cols["baryon"], dtype=np.int64)
    sign = np.where(baryon_arr % 2 == 0, -1, 1).astype(np.int64)

    table = ParticleTable(
        mc_id=np.asarray(cols["mc_id"], dtype=np.int64),
        name=cols["name"],
        mass=np.asarray(cols["mass"]),
        width=np.asarray(cols["width"]),
        gspin=np.asarray(cols["gspin"]),
        baryon=baryon_arr,
        strange=np.asarray(cols["strange"], dtype=np.int64),
        charm=np.asarray(cols["charm"], dtype=np.int64),
        bottom=np.asarray(cols["bottom"], dtype=np.int64),
        gisospin=np.asarray(cols["gisospin"], dtype=np.int64),
        charge=np.asarray(cols["charge"], dtype=np.int64),
        sign=sign,
        stable=np.asarray(stable, dtype=bool),
        decays_n=decays_n,
        decays_branch=decays_branch,
        decays_part=decays_part,
    )
    n_bar = int((table.baryon > 0).sum())
    n_antibar = int((table.baryon < 0).sum())
    if n_bar != n_antibar:
        raise ValueError("(anti)baryons not paired correctly")
    return table


# ------------------------------------------------------- smash-box (mcid) path

def decode_mcid(mcid: int) -> dict:
    """Decode quantum numbers from a PDG Monte-Carlo id
    (reference: src/cpp/readindata.cpp:1201-1424)."""
    if mcid < 0:
        raise ValueError("decode_mcid expects particle (positive) ids")
    digits = [(mcid // 10**i) % 10 for i in range(10)]
    nJ, nq3, nq2, nq1, nL, nR, n, n8, n9, n10 = digits
    nJ += n8  # spins > 9 spill into the 8th digit

    is_deuteron = (mcid == 1000010020)
    is_hadron = (not is_deuteron) and nq3 != 0 and nq2 != 0
    is_meson = is_hadron and nq1 == 0
    is_baryon_ = is_hadron and nq1 != 0
    if not (is_hadron or is_deuteron):
        raise ValueError(f"mcid {mcid} is not a hadron or deuteron")

    if is_deuteron:
        gspin, baryon, sign = 3, 2, -1
        has_anti = True
    else:
        gspin = nJ if nJ > 0 else 1  # K0L/K0S special-case spin 0
        baryon = 1 if is_baryon_ else 0
        sign = 1 if is_baryon_ else -1
        # K0L (130) / K0S (310) are self-conjugate, but the digit rule
        # nq2 != nq3 marks them as having antiparticles -- the reference
        # (readindata.cpp:1411) has the same defect; it is latent there
        # and here only because the shipped pdg_box.dat lists kaons as
        # 311/321.  Guard explicitly so a file listing 130/310 doesn't
        # double-count them in every HRG sum.
        has_anti = (mcid not in (130, 310)) and \
            ((baryon != 0) or (nq2 != nq3))
    return dict(gspin=gspin, baryon=baryon, sign=sign,
                has_antiparticle=has_anti)


def read_resonances_smash_box(path: str) -> ParticleTable:
    """Parse the smash-box PDG format (reference: readindata.cpp:1571-1684):
    ``name mass width parity mcid [mcid...]`` per line, antiparticles created
    inline after each species that has a distinct antiparticle."""
    cols = {k: [] for k in ("mc_id", "name", "mass", "width", "gspin",
                            "baryon", "sign")}

    with open(path) as f:
        for line in f:
            stripped = line.split("#", 1)[0].strip()  # inline comments allowed
            if not stripped:
                continue
            parts = stripped.split()
            name = parts[0]
            mass = float(parts[1])
            width = float(parts[2])
            # parts[3] is parity; remaining tokens are mc ids
            for tok in parts[4:]:
                mcid = int(tok)
                if mcid == 0:
                    continue
                info = decode_mcid(mcid)
                cols["mc_id"].append(mcid)
                cols["name"].append(name)
                cols["mass"].append(mass)
                cols["width"].append(width)
                cols["gspin"].append(info["gspin"])
                cols["baryon"].append(info["baryon"])
                cols["sign"].append(info["sign"])
                if info["has_antiparticle"]:
                    cols["mc_id"].append(-mcid)
                    cols["name"].append("Anti-" + name)
                    cols["mass"].append(mass)
                    cols["width"].append(width)
                    cols["gspin"].append(info["gspin"])
                    cols["baryon"].append(-info["baryon"])
                    cols["sign"].append(info["sign"])

    n = len(cols["mc_id"])
    zeros_i = np.zeros(n, dtype=np.int64)
    return ParticleTable(
        mc_id=np.asarray(cols["mc_id"], dtype=np.int64),
        name=cols["name"],
        mass=np.asarray(cols["mass"]),
        width=np.asarray(cols["width"]),
        gspin=np.asarray(cols["gspin"], dtype=np.float64),
        baryon=np.asarray(cols["baryon"], dtype=np.int64),
        strange=zeros_i, charm=zeros_i.copy(), bottom=zeros_i.copy(),
        gisospin=zeros_i.copy(), charge=zeros_i.copy(),
        sign=np.asarray(cols["sign"], dtype=np.int64),
        stable=np.ones(n, dtype=bool),  # box list carries no decay info
        decays_n=[np.zeros(0, dtype=np.int64)] * n,
        decays_branch=[np.zeros(0)] * n,
        decays_part=[np.zeros((0, MAX_DECAY_PART), dtype=np.int64)] * n,
    )


_EOS_FILES = {1: "pdg-urqmd_v3.3+.dat", 2: "pdg_smash.dat", 3: "pdg_box.dat"}


def read_resonances(pdg_dir: str, hrg_eos: int) -> ParticleTable:
    """Dispatch on the HRG EoS choice (reference: readindata.cpp:1687-1716)."""
    path = f"{pdg_dir}/{_EOS_FILES[hrg_eos]}"
    if hrg_eos in (1, 2):
        return read_resonances_conventional(path)
    if hrg_eos == 3:
        return read_resonances_smash_box(path)
    raise ValueError(f"hrg_eos must be 1, 2 or 3, got {hrg_eos}")


def load_chosen_mcids(path: str) -> np.ndarray:
    """Chosen-particle mc-id list, one id per row.  Tolerates (and does not
    require) the reference's trailing-blank-line quirk (iS3D.cpp:153-156)."""
    ids = []
    with open(path) as f:
        for line in f:
            s = line.split()
            if s:
                ids.append(int(float(s[0])))
    return np.asarray(ids, dtype=np.int64)


def chosen_indices(table: ParticleTable, chosen_mcids,
                   group_by_mass: bool = False,
                   skip_missing: bool = False) -> np.ndarray:
    """Map chosen mc ids to table indices, preserving chosen-file order
    (reference: emissionfunction.cpp:336-351); optionally mass-sorted
    (GROUP_PARTICLES bubble sort, emissionfunction.cpp:354-369 — we use a
    stable sort, equivalent ordering for distinct masses).

    skip_missing: drop (with a warning) chosen ids absent from the table —
    the reference's matching loop simply never matches them, so e.g. a
    smash-only resonance in chosen_particles.dat used with hrg_eos=1
    completes upstream; default is strict for programmatic callers."""
    if skip_missing:
        ids = {int(v) for v in table.mc_id}
        present = [m for m in chosen_mcids if int(m) in ids]
        missing = [int(m) for m in chosen_mcids if int(m) not in ids]
        if missing:
            print(f"[is3d_tpu_torch] warning: {len(missing)} chosen mc id(s) not "
                  f"in the particle table and skipped: {missing[:10]}"
                  f"{' ...' if len(missing) > 10 else ''}")
        chosen_mcids = present
    idx = np.asarray([table.index_of_mcid(m) for m in chosen_mcids], dtype=np.int64)
    if group_by_mass:
        order = np.argsort(table.mass[idx], kind="stable")
        idx = idx[order]
    return idx
