"""Volumetric and polydata I/O: XDMF2+RAW scalar fields, legacy-VTK polydata.

Format-compatible with the reference (``src/odil/io.py``): the XMF metadata
uses the XDMF2 CORECTMesh layout readable by ParaView/VisIt, the RAW file is
a plain binary dump, and the VTK writer emits legacy POLYDATA (ASCII or
big-endian binary).

The port's own copy of ``odil_tpu/io.py`` (numpy only).
"""

import os
import xml.etree.ElementTree as _ET

import numpy as np

__all__ = [
    "parse_raw_xmf",
    "read_raw",
    "read_raw_with_xmf",
    "write_raw_xmf",
    "write_raw_with_xmf",
    "write_vtk_poly",
]

_XMF_TEMPLATE = """\
<?xml version="1.0" ?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="2.0">
 <Domain>
   <Grid Name="mesh" GridType="Uniform">
     <Topology TopologyType="{dim}DCORECTMesh" Dimensions="{nodes}"/>
     <Geometry GeometryType="{geomtype}">
       <DataItem Name="Origin" Dimensions="{dim}" NumberType="Float" Precision="8" Format="XML">
         {origin}
       </DataItem>
       <DataItem Name="Spacing" Dimensions="{dim}" NumberType="Float" Precision="8" Format="XML">
         {spacing}
       </DataItem>
     </Geometry>
     <Attribute Name="{name}" AttributeType="Scalar" Center="{center}">
       <DataItem ItemType="HyperSlab" Dimensions="{countd}" Type="HyperSlab">
           <DataItem Dimensions="3 {dim}" Format="XML">
             {start}
             {stride}
             {count}
           </DataItem>
           <DataItem Dimensions="{bindim}" Seek="{seek}" Precision="{precision}" NumberType="{type}" Format="Binary">
             {binpath}
           </DataItem>
       </DataItem>
     </Attribute>
   </Grid>
 </Domain>
</Xdmf>
"""


def parse_raw_xmf(xmfpath):
    """Parses XMF metadata; returns dict with rawpath, count, spacing, name,
    precision, cell.

    Walks the XDMF2 document tree (rather than pattern-matching the text):
    the scalar ``Attribute`` supplies the name and centering, the binary
    ``DataItem`` under it supplies the raw-file path, element count and
    precision, and the geometry's ``Spacing`` item supplies the grid steps
    (stored z-major in the file, returned x-major here).
    """
    root = _ET.parse(xmfpath).getroot()

    attr = root.find(".//Attribute[@AttributeType='Scalar']")
    if attr is None:
        raise RuntimeError(f"No scalar Attribute in '{xmfpath}'")
    center = attr.get("Center", "")
    if center not in ("Cell", "Node"):
        raise RuntimeError(f"Unknown Center='{center}'")

    binitem = attr.find(".//DataItem[@Format='Binary']")
    if binitem is None:
        raise RuntimeError(f"No binary DataItem in '{xmfpath}'")
    count = tuple(int(v) for v in binitem.get("Dimensions", "").split())
    precision = int(binitem.get("Precision", "8"))
    rawpath = os.path.join(os.path.dirname(xmfpath), (binitem.text or "").strip())

    spacing_item = root.find(".//DataItem[@Name='Spacing']")
    if spacing_item is None:
        raise RuntimeError(f"No Spacing DataItem in '{xmfpath}'")
    spacing = tuple(float(v) for v in reversed((spacing_item.text or "").split()))

    return {
        "rawpath": rawpath,
        "count": count,
        "spacing": spacing,
        "name": attr.get("Name", ""),
        "precision": precision,
        "cell": center == "Cell",
    }


def read_raw_with_xmf(xmfpath):
    """Reads a scalar field from RAW+XMF; returns (array, metadata)."""
    meta = parse_raw_xmf(xmfpath)
    dtype = {4: np.float32, 8: np.float64}[meta["precision"]]
    u = np.fromfile(meta["rawpath"], dtype).reshape(meta["count"])
    return u, meta


def read_raw(xmfpath):
    return read_raw_with_xmf(xmfpath)


def write_raw_xmf(xmfpath, rawpath, count, spacing=(1, 1, 1), name=None, precision=8, cell=True):
    """Writes XMF metadata for a RAW datafile with shape `count` = (Nz, Ny, Nx)."""
    name = name or "data"
    dim = 3

    def rev(v):
        return " ".join(map(str, reversed(v)))

    def fwd(v):
        return " ".join(map(str, v))

    info = dict(
        name=name,
        dim=dim,
        origin=rev([0] * dim),
        spacing=rev(spacing),
        start=rev([0] * dim),
        stride=rev([1] * dim),
        count=fwd(count),
        bindim=fwd(count),
        countd=fwd(count),
        nodes=fwd([a + 1 for a in count]) if cell else fwd(list(count)),
        center="Cell" if cell else "Node",
        precision=precision,
        type="Double" if precision == 8 else "Float",
        binpath=rawpath,
        seek="0",
        geomtype="ORIGIN_DXDYDZ",
    )
    with open(xmfpath, "w") as f:
        f.write(_XMF_TEMPLATE.format(**info))


def write_raw_with_xmf(u, xmfpath, rawpath=None, spacing=(1, 1, 1), cell=True, name=None):
    """Writes `u` (shape (Nz, Ny, Nx), lower-dim arrays promoted) as RAW+XMF."""
    u = np.asarray(u)
    if u.ndim != 3:
        u = u.reshape((1,) * (3 - u.ndim) + u.shape)
    spacing = list(spacing)
    if len(spacing) != 3:
        spacing = spacing + [min(spacing)] * (3 - len(spacing))
    precision = 4 if u.dtype == np.float32 else 8
    if rawpath is None:
        rawpath = os.path.splitext(xmfpath)[0] + ".raw"
    relraw = os.path.relpath(rawpath, start=os.path.dirname(xmfpath) or ".")
    write_raw_xmf(xmfpath, relraw, u.shape, spacing, name, precision, cell)
    u.tofile(rawpath)
    return xmfpath


def write_vtk_poly(
    fout,
    points,
    polygons=None,
    lines=None,
    point_fields=None,
    cell_fields=None,
    tcoords=None,
    comment="",
    fmt="%.16g",
    binary=False,
):
    """Writes points/polygons/lines with fields to a legacy VTK POLYDATA file."""
    path = fout if isinstance(fout, str) else None
    if path is not None:
        fout = open(path, "wb")

    def put(text=""):
        if isinstance(text, str):
            text = text.encode()
        fout.write(text + b"\n")

    def put_array(array):
        if binary:
            np.asarray(array, dtype=">f").tofile(fout)
        else:
            np.savetxt(fout, array, fmt=fmt)

    put("# vtk DataFile Version 2.0")
    put(comment)
    put("BINARY" if binary else "ASCII")
    put("DATASET POLYDATA")

    npoints = len(points)
    put(f"POINTS {npoints} float")
    put_array(points)

    ncells = 0
    if polygons is not None:
        ncells = len(polygons)
        total = ncells + sum(len(p) for p in polygons)
        put(f"POLYGONS {ncells} {total}")
        for p in polygons:
            put(" ".join(map(str, [len(p)] + list(p))))

    if lines is not None:
        total = len(lines) + sum(len(p) for p in lines)
        put(f"LINES {len(lines)} {total}")
        for p in lines:
            if binary:
                np.array([len(p)] + list(p), dtype=">i4").tofile(fout)
            else:
                put(" ".join(map(str, [len(p)] + list(p))))

    if point_fields is not None or tcoords is not None:
        put(f"POINT_DATA {npoints}")

    if point_fields is not None:
        for name, array in point_fields.items():
            array = np.reshape(array, -1)
            if array.size != npoints:
                raise RuntimeError(f"Expected array.size={array.size} == npoints={npoints}")
            put(f"SCALARS {name} float")
            put("LOOKUP_TABLE default")
            put_array(array)

    if tcoords is not None:
        if tcoords.shape != (npoints, 2):
            raise RuntimeError(f"Expected shape ({npoints}, 2), got {tcoords.shape}")
        put("TEXTURE_COORDINATES tcoords 2 float")
        put_array(tcoords)

    if cell_fields is not None:
        put(f"CELL_DATA {ncells}")
        for name, array in cell_fields.items():
            array = np.reshape(array, -1)
            if array.size != ncells:
                raise RuntimeError(f"Expected array.size={array.size} == ncells={ncells}")
            put(f"SCALARS {name} float")
            put("LOOKUP_TABLE default")
            put_array(array)

    if path is not None:
        fout.close()
