"""SQL builders for querying simulation event databases.

Parity: reference ``pvtrace/cli/db.py`` — boundary semantics (entering =
TRANSMIT with adjacent==node, escaping = TRANSMIT with container==node,
reflected = REFLECT with adjacent==node; volume events match on
container), facet-normal filters with per-component tolerance, and
``DISTINCT throw_id`` counting. Each function returns ``(sql, params)``.
"""
from typing import Optional

_BOUNDARY = {
    "reflected": ("REFLECT", "adjacent"),
    "entering": ("TRANSMIT", "adjacent"),
    "escaping": ("TRANSMIT", "container"),
}
_VOLUME = {
    "nonradiative": "NONRADIATIVE",
    "reacted": "REACT",
    "killed": "KILL",
}


def _normal_clauses(nx, ny, nz, atol):
    lines, params = [], []
    for value, column in ((nx, "ni"), (ny, "nj"), (nz, "nk")):
        if value is not None:
            lines.append(f"AND (ABS(? - {column}) <= ?)")
            params.extend([value, atol])
    return lines, params


def _boundary_query(columns, node, kind, other_column, nx=None, ny=None,
                    nz=None, facet=None, source=None, atol=1e-6, count=False):
    inner = [
        f"SELECT DISTINCT {columns} FROM ray",
        "INNER JOIN event ON ray.rowid = event.ray_id",
        "WHERE hit = ?",
        f"AND {other_column} = ?",
        "AND kind = ?",
    ]
    params = [node, node, kind]
    lines, extra = _normal_clauses(nx, ny, nz, atol)
    inner.extend(lines)
    params.extend(extra)
    if facet:
        inner.append("AND facet = ?")
        params.append(facet)
    if source:
        inner.append("AND source = ?")
        params.append(source)
    outer = "SELECT COUNT('throw_id')" if count else f"SELECT {columns}"
    sql = "{} FROM ( {} )".format(outer, "\n".join(inner))
    return sql, tuple(params)


def _volume_query(columns, node, kind, source=None, count=False):
    inner = [
        f"SELECT DISTINCT {columns} FROM ray",
        "INNER JOIN event ON ray.rowid = event.ray_id",
        "WHERE container = ?",
        "AND kind = ?",
    ]
    params = [node, kind]
    if source:
        inner.append("AND source = ?")
        params.append(source)
    outer = "SELECT COUNT('throw_id')" if count else f"SELECT {columns}"
    sql = "{} FROM ( {} )".format(outer, "\n".join(inner))
    return sql, tuple(params)


def _make_boundary(columns, count):
    def build(selector):
        kind, other = _BOUNDARY[selector]

        def fn(node: str, nx: Optional[float] = None, ny: Optional[float] = None,
               nz: Optional[float] = None, facet: Optional[str] = None,
               source: Optional[str] = None, atol: float = 1e-6):
            return _boundary_query(
                columns, node, kind, other, nx=nx, ny=ny, nz=nz, facet=facet,
                source=source, atol=atol, count=count,
            )

        return fn

    return build


def _make_volume(columns, count):
    def build(selector):
        kind = _VOLUME[selector]

        def fn(node: str, source: Optional[str] = None):
            return _volume_query(columns, node, kind, source=source, count=count)

        return fn

    return build


# -- counts (DISTINCT throw_id) ---------------------------------------

sql_count_reflected_from_node = _make_boundary("throw_id", True)("reflected")
sql_count_entering_into_node = _make_boundary("throw_id", True)("entering")
sql_count_escaping_from_node = _make_boundary("throw_id", True)("escaping")
sql_count_nonradiative_loss_in_node = _make_volume("throw_id", True)("nonradiative")
sql_count_reacted_in_node = _make_volume("throw_id", True)("reacted")
sql_count_killed_in_node = _make_volume("throw_id", True)("killed")

# -- spectra (wavelength per distinct ray) ----------------------------

sql_spectrum_reflected_from_node = _make_boundary(
    "throw_id, wavelength", False
)("reflected")
sql_spectrum_entering_into_node = _make_boundary(
    "throw_id, wavelength", False
)("entering")
sql_spectrum_escaping_from_node = _make_boundary(
    "throw_id, wavelength", False
)("escaping")
sql_spectrum_nonradiative_loss_in_node = _make_volume(
    "throw_id, wavelength", False
)("nonradiative")
sql_spectrum_reacted_in_node = _make_volume(
    "throw_id, wavelength", False
)("reacted")
sql_spectrum_killed_in_node = _make_volume(
    "throw_id, wavelength", False
)("killed")

# -- time of flight (duration per distinct ray) -----------------------

sql_time_reflected_from_node = _make_boundary(
    "throw_id, duration", False
)("reflected")
sql_time_entering_into_node = _make_boundary(
    "throw_id, duration", False
)("entering")
sql_time_escaping_from_node = _make_boundary(
    "throw_id, duration", False
)("escaping")
sql_time_nonradiative_loss_in_node = _make_volume(
    "throw_id, duration", False
)("nonradiative")
sql_time_reacted_in_node = _make_volume("throw_id, duration", False)("reacted")
sql_time_killed_in_node = _make_volume("throw_id, duration", False)("killed")
