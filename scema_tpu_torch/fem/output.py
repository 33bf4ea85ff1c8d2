"""Visualisation and analytics outputs: VTK XML, PVD time series, CSVs.

Torch twin of ``scema_tpu/fem/output.py``: the writers are numpy, as
there, and take the port's FE state (tensors on any device, brought to the
host at the file boundary).  On the CPU in float64 every file equals the
JAX package's byte for byte.

reference: FE_problem.h output stack —
* ``output_visualisation_solution`` (:2126-2254): per-rank .vtu + .pvtu/
  .visit/.pvd masters with displacement/velocity;
* ``compute_history_projection_from_qp_to_nodes`` (:1863-1937): L2
  projection of the qp strain/stress history onto a per-cell
  discontinuous (DG-Q1) nodal field;
* ``output_visualisation_history`` (:2050-2121): the projected history
  written as history-* VTU/pvtu/visit pieces + a history.pvd collection;
* ``output_lhistory`` (:1984-2045): per-qp strain/stress CSV;
* ``output_lbc_force`` (:1941-1980): loaded-boundary reaction-force CSV.

Single-process SPMD writes one .vtu per step (no per-rank sharding needed)
referenced from a .pvd collection.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# bit-ordered hex vertices -> VTK_HEXAHEDRON (type 12) ordering
_BIT_TO_VTK = (0, 1, 3, 2, 4, 5, 7, 6)


def write_vtu(
    path: str,
    nodes: np.ndarray,
    cells: np.ndarray,
    point_data: dict[str, np.ndarray] | None = None,
    cell_data: dict[str, np.ndarray] | None = None,
) -> None:
    """ASCII VTK XML unstructured grid of hexahedra."""
    nodes = _np(nodes)
    cells = _np(cells)[:, _BIT_TO_VTK]
    n_pts, n_cells = len(nodes), len(cells)

    def data_arrays(data, n_expected):
        out = []
        for name, arr in (data or {}).items():
            arr = _np(arr)
            if arr.ndim == 1:
                arr = arr[:, None]
            assert arr.shape[0] == n_expected, (name, arr.shape, n_expected)
            ncomp = arr.shape[1]
            body = "\n".join(" ".join(f"{v:.9g}" for v in row) for row in arr)
            out.append(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii">\n{body}\n</DataArray>'
            )
        return "\n".join(out)

    points = "\n".join(" ".join(f"{v:.9g}" for v in p) for p in nodes)
    conn = "\n".join(" ".join(str(v) for v in c) for c in cells)
    offsets = " ".join(str(8 * (i + 1)) for i in range(n_cells))
    types = " ".join("12" for _ in range(n_cells))

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">
<Points>
<DataArray type="Float64" NumberOfComponents="3" format="ascii">
{points}
</DataArray>
</Points>
<Cells>
<DataArray type="Int32" Name="connectivity" format="ascii">
{conn}
</DataArray>
<DataArray type="Int32" Name="offsets" format="ascii">
{offsets}
</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">
{types}
</DataArray>
</Cells>
<PointData>
{data_arrays(point_data, n_pts)}
</PointData>
<CellData>
{data_arrays(cell_data, n_cells)}
</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    with open(path, "w") as f:
        f.write(xml)


def qp_to_dg_projection_matrix(n_gauss: int) -> np.ndarray:
    """(8, n_qp) matrix projecting per-cell quadrature-point values onto
    the cell's DG-Q1 nodal dofs by reference-cell L2 projection —
    deal.II's ``FETools::compute_projection_from_quadrature_points_matrix``
    as used by the reference (FE_problem.h:1878-1882): solve
    M a = B W f with M_ij = sum_q phi_i(x_q) w_q phi_j(x_q).

    For the 2x2x2 Gauss rule (the shipped configs' quadrature) B is
    square/invertible so the projection recovers any trilinear field
    exactly at the nodes; for higher rules it is the least-squares fit.
    """
    from .shapes import q1_shape_values, tensor_quadrature

    pts, wts = tensor_quadrature(n_gauss)
    B = q1_shape_values(pts).T  # (8, n_qp)
    BW = B * wts  # row-scale by quadrature weights
    M = BW @ B.T
    return np.linalg.solve(M, BW)


def project_history_to_nodes(qp_field: np.ndarray, n_cells: int) -> np.ndarray:
    """qp history tensor (n_qp_total, 6) -> DG nodal values
    (n_cells * 8, 6), the rebuild of FE_problem.h:1863-1937."""
    qp_field = _np(qp_field)
    n_qp_per_cell = qp_field.shape[0] // n_cells
    n_gauss = round(n_qp_per_cell ** (1.0 / 3.0))
    P = qp_to_dg_projection_matrix(n_gauss)  # (8, n_qp_per_cell)
    cellwise = qp_field.reshape(n_cells, n_qp_per_cell, -1)
    return np.einsum("dq,cqk->cdk", P, cellwise).reshape(n_cells * 8, -1)


def write_pvtu(path: str, pieces: list[str], point_data: dict,
               cell_data: dict) -> None:
    """Parallel-collection master referencing per-rank .vtu pieces
    (DataOut::write_pvtu_record, FE_problem.h:2238-2241)."""
    def decls(data):
        out = []
        for name, arr in data.items():
            arr = _np(arr)
            nc = 1 if arr.ndim == 1 else arr.shape[1]
            out.append(f'      <PDataArray type="Float64" Name="{name}" '
                       f'NumberOfComponents="{nc}"/>\n')
        return "".join(out)

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PUnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write('  <PUnstructuredGrid GhostLevel="0">\n')
        f.write('    <PPoints>\n      <PDataArray type="Float64" '
                'NumberOfComponents="3"/>\n    </PPoints>\n')
        f.write("    <PPointData>\n" + decls(point_data) + "    </PPointData>\n")
        f.write("    <PCellData>\n" + decls(cell_data) + "    </PCellData>\n")
        for p in pieces:
            f.write(f'    <Piece Source="{p}"/>\n')
        f.write("  </PUnstructuredGrid>\n</VTKFile>\n")


def write_pvd(path: str, entries: list[tuple[float, str]]) -> None:
    """ParaView .pvd collection (the reference's .pvd master,
    FE_problem.h:2232-2253)."""
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
        "<Collection>",
    ]
    for t, fname in entries:
        lines.append(f'<DataSet timestep="{t:.10g}" group="" part="0" file="{fname}"/>')
    lines += ["</Collection>", "</VTKFile>", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


class OutputWriter:
    """Stateful output manager for an HMM run (frequencies from config
    'output data', dealammps.cc:286-291)."""

    def __init__(self, outdir: str, nodes: np.ndarray, cells: np.ndarray,
                 resume: bool = False, resume_timestep: int | None = None):
        """``resume=True`` (a restarted run writing into the same outdir)
        preserves the existing reaction-force CSV and re-reads the
        solution.pvd collection so pre-restart timesteps stay referenced —
        a fresh writer would silently truncate both.  ``resume_timestep``
        (the restored checkpoint's step counter) additionally drops CSV
        rows written AFTER that step by a crashed run, so a resume never
        appends duplicate, out-of-order rows."""
        self.outdir = outdir
        self.nodes = _np(nodes)
        self.cells = _np(cells)
        self.pvd_entries: list[tuple[float, str]] = []
        self.history_pvd_entries: list[tuple[float, str]] = []
        os.makedirs(outdir, exist_ok=True)
        self._lbc_path = os.path.join(outdir, "loaded_boundary_force.csv")
        if resume:
            import re

            for entries, name in ((self.pvd_entries, "solution.pvd"),
                                  (self.history_pvd_entries, "history.pvd")):
                pvd = os.path.join(outdir, name)
                if not os.path.exists(pvd):
                    continue
                for m in re.finditer(
                    r'<DataSet\s+timestep="([^"]+)"[^>]*file="([^"]+)"',
                    open(pvd).read(),
                ):
                    entries.append((float(m.group(1)), m.group(2)))
        if not (resume and os.path.exists(self._lbc_path)):
            with open(self._lbc_path, "w") as f:
                f.write("timestep,time,reaction_force\n")
        elif resume_timestep is not None:
            self._truncate_after(resume_timestep)

    def _truncate_after(self, ts: int) -> None:
        """Rewrite appended CSVs keeping only rows with timestep <= ts."""
        def keep(path, col):
            if not os.path.exists(path):
                return
            with open(path) as f:
                lines = f.readlines()
            kept = [lines[0]] + [
                ln for ln in lines[1:]
                if ln.strip() and int(float(ln.split(",")[col])) <= ts
            ]
            if len(kept) != len(lines):
                with open(path, "w") as f:
                    f.writelines(kept)

        keep(self._lbc_path, 0)
        import glob as _glob

        for p in _glob.glob(os.path.join(self.outdir, "mddata_qpid*.csv")):
            keep(p, 2)  # time_id column

    def write_visualisation(self, fe_state, timestep: int, time: float) -> str:
        n_qp_per_cell = len(_np(fe_state.qp.new_strain)) // len(self.cells)
        u = _np(fe_state.u).reshape(-1, 3)
        v = _np(fe_state.v).reshape(-1, 3)
        strain = _np(fe_state.qp.new_strain).reshape(len(self.cells), n_qp_per_cell, 6)
        stress = _np(fe_state.qp.new_stress).reshape(len(self.cells), n_qp_per_cell, 6)
        mat = _np(fe_state.qp.material).reshape(len(self.cells), n_qp_per_cell)
        fname = f"solution-{timestep:06d}.vtu"
        point_data = {"displacement": u, "velocity": v}
        cell_data = {
            "strain": strain.mean(axis=1),
            "stress": stress.mean(axis=1),
            "material": mat[:, 0].astype(float),
            "von_mises": _von_mises(stress.mean(axis=1)),
        }
        # production-size meshes use the native binary-appended writer
        # (native/scema_native.cpp); small meshes stay human-readable ASCII
        path = os.path.join(self.outdir, fname)
        wrote = False
        if len(self.cells) >= 4096:
            from ..native import write_vtu_native

            wrote = write_vtu_native(path, self.nodes, self.cells, point_data, cell_data)
        if not wrote:
            write_vtu(path, self.nodes, self.cells, point_data, cell_data)
        # parallel-collection masters alongside, as the reference emits
        # per step (FE_problem.h:2232-2253): a .pvtu referencing the
        # piece(s) and a .visit record for VisIt
        base = f"solution-{timestep:06d}"
        write_pvtu(os.path.join(self.outdir, base + ".pvtu"), [fname],
                   point_data, cell_data)
        with open(os.path.join(self.outdir, base + ".visit"), "w") as f:
            f.write("!NBLOCKS 1\n")
            f.write(fname + "\n")
        self.pvd_entries.append((time, base + ".pvtu"))
        write_pvd(os.path.join(self.outdir, "solution.pvd"), self.pvd_entries)
        return fname

    def write_visualisation_history(self, fe_state, timestep: int,
                                    time: float) -> str:
        """qp strain/stress history projected to per-cell DG-Q1 nodes and
        written as a discontinuous VTU + pvtu/visit masters + history.pvd
        (FE_problem.h:2050-2121 ``output_visualisation_history``; component
        names strain_xx..yz / stress_xx..yz match :2067-2073)."""
        n_cells = len(self.cells)
        strain = project_history_to_nodes(
            _np(fe_state.qp.new_strain), n_cells)
        stress = project_history_to_nodes(
            _np(fe_state.qp.new_stress), n_cells)
        # discontinuous mesh: every cell owns private copies of its 8
        # corner points (deal.II's history_dof_handler over FE_DGQ)
        dg_nodes = self.nodes[self.cells].reshape(-1, 3)
        dg_cells = np.arange(n_cells * 8, dtype=np.int32).reshape(n_cells, 8)
        comp = ("xx", "yy", "zz", "xy", "xz", "yz")  # our Voigt order
        point_data = {}
        for k, c in enumerate(comp):
            point_data[f"strain_{c}"] = strain[:, k]
        for k, c in enumerate(comp):
            point_data[f"stress_{c}"] = stress[:, k]
        fname = f"history-{timestep:06d}.vtu"
        # same native-binary switch as write_visualisation — the DG mesh
        # carries 8x the point count and 12 scalar arrays, so the ASCII
        # Python writer would block the step loop for seconds at
        # production sizes
        path = os.path.join(self.outdir, fname)
        wrote = False
        if n_cells >= 4096:
            from ..native import write_vtu_native

            wrote = write_vtu_native(path, dg_nodes, dg_cells,
                                     point_data, {})
        if not wrote:
            write_vtu(path, dg_nodes, dg_cells, point_data, {})
        base = f"history-{timestep:06d}"
        write_pvtu(os.path.join(self.outdir, base + ".pvtu"), [fname],
                   point_data, {})
        with open(os.path.join(self.outdir, base + ".visit"), "w") as f:
            f.write("!NBLOCKS 1\n")
            f.write(fname + "\n")
        self.history_pvd_entries.append((time, base + ".pvtu"))
        write_pvd(os.path.join(self.outdir, "history.pvd"),
                  self.history_pvd_entries)
        return fname

    def write_mesh_eps(self, path: str | None = None) -> str:
        """Wireframe EPS of the mesh (FEProblem::visualise_mesh,
        FE_problem.h:168-179 / deal.II GridOut::write_eps): orthographic
        projection at the deal.II default view (azimut 60, turn 30)."""
        path = path or os.path.join(self.outdir, "3D_mesh.eps")
        az, tu = np.deg2rad(60.0), np.deg2rad(30.0)
        # deal.II eps projection: view direction from (azimut, turn)
        ca, sa = np.cos(az), np.sin(az)
        ct, st = np.cos(tu), np.sin(tu)
        ux = np.array([-sa, ca, 0.0])
        uy = np.array([-ca * st, -sa * st, ct])
        p2 = np.stack([self.nodes @ ux, self.nodes @ uy], axis=1)
        lo, hi = p2.min(axis=0), p2.max(axis=0)
        span = np.maximum(hi - lo, 1e-30)
        scale = 280.0 / span.max()
        p2 = (p2 - lo) * scale + 10.0

        # unique hex edges (bit-ordered vertices: x fastest, then y, z)
        edge_local = [
            (0, 1), (2, 3), (4, 5), (6, 7),
            (0, 2), (1, 3), (4, 6), (5, 7),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        seen = set()
        lines = []
        for cell in self.cells:
            for a, b in edge_local:
                key = (min(cell[a], cell[b]), max(cell[a], cell[b]))
                if key in seen:
                    continue
                seen.add(key)
                pa, pb = p2[key[0]], p2[key[1]]
                lines.append(f"{pa[0]:.2f} {pa[1]:.2f} m {pb[0]:.2f} "
                             f"{pb[1]:.2f} x\n")
        with open(path, "w") as f:
            f.write("%!PS-Adobe-2.0 EPSF-1.2\n%%Title: scema mesh\n")
            f.write(f"%%BoundingBox: 0 0 {int(p2[:, 0].max() + 10)} "
                    f"{int(p2[:, 1].max() + 10)}\n")
            f.write("/m {moveto} bind def\n/x {lineto stroke} bind def\n")
            f.write("0.3 setlinewidth\n")
            f.writelines(lines)
            f.write("showpage\n")
        return path

    _TRIU = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    _V2T = [0, 3, 4, 1, 5, 2]  # Voigt [xx yy zz xy xz yz] -> triu order

    def write_mddata(self, timestep: int, qp_ids, material, strain_cg,
                     stress_repl, temperature: float, strain_rate: float,
                     force_field: str) -> None:
        """Per-(qp, replica) MD log rows (STMDProblem::write_local_data,
        stmd_problem.h:394-456) — appended one file per (qp, replica),
        header identical to the reference's."""
        strain_cg = _np(strain_cg)
        stress_repl = _np(stress_repl)  # (n_qp, n_repl, 6)
        n_repl = stress_repl.shape[1]
        hdr = ("qp_id,material_id,time_id,temperature,strain_rate,"
               "force_field,replica_id")
        for k, l in self._TRIU:
            hdr += f",strain_{k}{l}"
        for k, l in self._TRIU:
            hdr += f",stress_{k}{l}"
        for q in qp_ids:
            for r in range(n_repl):
                path = os.path.join(self.outdir,
                                    f"mddata_qpid{q}_repl{r + 1}.csv")
                new = not os.path.exists(path) or os.path.getsize(path) == 0
                with open(path, "a") as f:
                    if new:
                        f.write(hdr + "\n")
                    eps_t = strain_cg[q][self._V2T]
                    sig_t = stress_repl[q, r][self._V2T]
                    vals = ",".join(f"{x:.16g}"
                                    for x in np.concatenate([eps_t, sig_t]))
                    f.write(f"{q},{int(material[q])},{timestep},"
                            f"{temperature:.10g},{strain_rate:.10g},"
                            f"{force_field},{r + 1},{vals}\n")

    def write_lbc_force(self, timestep: int, time: float, force: float) -> None:
        with open(self._lbc_path, "a") as f:
            f.write(f"{timestep},{time:.10g},{force:.10g}\n")

    def write_lhistory(self, fe_state, timestep: int) -> str:
        """Per-qp analytics CSV (pr_<p>.lhistory.csv analog)."""
        path = os.path.join(self.outdir, f"lhistory-{timestep:06d}.csv")
        strain = _np(fe_state.qp.new_strain)
        upd = _np(fe_state.qp.upd_strain)
        stress = _np(fe_state.qp.new_stress)
        with open(path, "w") as f:
            f.write(
                "qp,eps_xx,eps_yy,eps_zz,eps_xy,eps_xz,eps_yz,"
                "upd_xx,upd_yy,upd_zz,upd_xy,upd_xz,upd_yz,"
                "sig_xx,sig_yy,sig_zz,sig_xy,sig_xz,sig_yz\n"
            )
            for q in range(strain.shape[0]):
                row = ",".join(
                    f"{x:.9g}"
                    for x in np.concatenate([strain[q], upd[q], stress[q]])
                )
                f.write(f"{q},{row}\n")
        return path


def _von_mises(sig6: np.ndarray) -> np.ndarray:
    xx, yy, zz, xy, xz, yz = (sig6[:, k] for k in range(6))
    return np.sqrt(
        0.5 * ((xx - yy) ** 2 + (yy - zz) ** 2 + (zz - xx) ** 2)
        + 3.0 * (xy**2 + xz**2 + yz**2)
    )
