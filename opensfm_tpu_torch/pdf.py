"""A minimal PDF 1.4 writer for the port's quality report (no matplotlib,
no fpdf): A4 pages, text in the base-14 fonts Helvetica and Helvetica-Bold
with WinAnsiEncoding (nothing embedded), filled rectangles, ruled lines and
RGB images, each stream deflated by `zlib`.

Coordinates are in points from the page's top-left corner; the writer turns
them into PDF's bottom-left user space.  Text is written one `Tj` string a
call, encoded as Windows-1252 ('?' where a character has no byte there), so
`²` is byte 0xB2 and a reader can find every string in the content streams.
"""

from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple

import numpy as np

PAGE_W, PAGE_H = 595.28, 841.89  # A4 in points

# Advance widths (1/1000 em) of ' ' to '~' in the Adobe AFM metrics of
# Helvetica and Helvetica-Bold, with WinAnsiEncoding's quotesingle at 0x27
# and grave at 0x60; other characters count as 556.
_HELVETICA = (
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333,
    278, 278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278,
    584, 584, 584, 556, 1015, 667, 667, 722, 722, 667, 611, 778, 722, 278,
    500, 667, 556, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944,
    667, 667, 611, 278, 278, 278, 469, 556, 333, 556, 556, 500, 556, 556,
    278, 556, 556, 222, 222, 500, 222, 833, 556, 556, 556, 556, 333, 500,
    278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)
_HELVETICA_BOLD = (
    278, 333, 474, 556, 556, 889, 722, 238, 333, 333, 389, 584, 278, 333,
    278, 278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 333, 333,
    584, 584, 584, 611, 975, 722, 722, 722, 722, 667, 611, 778, 722, 278,
    556, 722, 611, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944,
    667, 667, 611, 333, 278, 333, 584, 556, 333, 556, 611, 556, 611, 556,
    333, 611, 611, 278, 278, 556, 278, 889, 611, 611, 611, 611, 389, 556,
    333, 611, 556, 778, 556, 556, 500, 389, 280, 389, 584)
_WIDTHS = {False: _HELVETICA, True: _HELVETICA_BOLD}
_SUPERSCRIPT_TWO = 333  # twosuperior, byte 0xB2, in both fonts


def encode_text(s: str) -> bytes:
    """`s` as WinAnsi (Windows-1252) bytes, '?' for what it lacks."""
    return s.encode("cp1252", errors="replace")


def escape(data: bytes) -> bytes:
    """Bytes inside a PDF literal string: `\\`, `(` and `)` escaped."""
    return (data.replace(b"\\", b"\\\\").replace(b"(", b"\\(")
            .replace(b")", b"\\)"))


def text_width(s: str, size: float, bold: bool = False) -> float:
    """Width in points of `s` at `size` points."""
    table = _WIDTHS[bold]
    units = 0
    for b in encode_text(s):
        if 32 <= b < 127:
            units += table[b - 32]
        elif b == 0xB2:
            units += _SUPERSCRIPT_TWO
        else:
            units += 556
    return units * size / 1000.0


def _num(v: float) -> bytes:
    text = f"{v:.3f}".rstrip("0").rstrip(".")
    return (text if text not in ("", "-0") else "0").encode()


def _rgb(color: Sequence[float]) -> bytes:
    return b" ".join(_num(c) for c in color)


class _Page:
    def __init__(self) -> None:
        self.ops: List[bytes] = []
        self.images: List[Tuple[bytes, np.ndarray]] = []


class PdfDocument:
    """Pages of text, rectangles, lines and images, written by `save`."""

    def __init__(self) -> None:
        self.pages: List[_Page] = []

    @property
    def page(self) -> _Page:
        if not self.pages:
            self.new_page()
        return self.pages[-1]

    def new_page(self) -> None:
        self.pages.append(_Page())

    def text(self, x: float, y: float, s: str, size: float,
             bold: bool = False, color: Sequence[float] = (0, 0, 0)) -> None:
        """`s` with its baseline at `y` points from the top, starting at x."""
        font = b"/F2" if bold else b"/F1"
        self.page.ops.append(
            b"BT " + font + b" " + _num(size) + b" Tf " + _rgb(color)
            + b" rg 1 0 0 1 " + _num(x) + b" " + _num(PAGE_H - y)
            + b" Tm (" + escape(encode_text(s)) + b") Tj ET")

    def rect(self, x: float, y: float, w: float, h: float,
             color: Sequence[float]) -> None:
        """A filled rectangle, its top-left corner at (x, y)."""
        self.page.ops.append(
            _rgb(color) + b" rg " + _num(x) + b" " + _num(PAGE_H - y - h)
            + b" " + _num(w) + b" " + _num(h) + b" re f")

    def line(self, x0: float, y0: float, x1: float, y1: float,
             width: float, color: Sequence[float]) -> None:
        self.page.ops.append(
            _rgb(color) + b" RG " + _num(width) + b" w " + _num(x0) + b" "
            + _num(PAGE_H - y0) + b" m " + _num(x1) + b" "
            + _num(PAGE_H - y1) + b" l S")

    def image(self, pixels: np.ndarray, x: float, y: float, w: float,
              h: float) -> None:
        """[H, W, 3] uint8 RGB pixels drawn into the box (x, y, w, h)."""
        pix = np.ascontiguousarray(pixels, dtype=np.uint8)
        if pix.ndim != 3 or pix.shape[2] != 3:
            raise ValueError(f"image takes [H, W, 3] pixels, not {pix.shape}")
        page = self.page
        name = b"/Im%d" % (len(page.images) + 1)
        page.images.append((name, pix))
        page.ops.append(
            b"q " + _num(w) + b" 0 0 " + _num(h) + b" " + _num(x) + b" "
            + _num(PAGE_H - y - h) + b" cm " + name + b" Do Q")

    def to_bytes(self) -> bytes:
        """The PDF file: catalog, page tree, two fonts, then each page, its
        content stream and its images, with the xref table of their byte
        offsets and the trailer."""
        objects: List[bytes] = []  # object k + 1

        def add(body: bytes) -> int:
            objects.append(body)
            return len(objects)

        def stream(head: bytes, data: bytes) -> bytes:
            packed = zlib.compress(data, 6)
            return (b"<< " + head + b" /Filter /FlateDecode /Length %d >>\n"
                    % len(packed) + b"stream\n" + packed + b"\nendstream")

        add(b"<< /Type /Catalog /Pages 2 0 R >>")
        add(b"")  # the page tree, filled in once the pages have numbers
        add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
            b"/Encoding /WinAnsiEncoding >>")
        add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold "
            b"/Encoding /WinAnsiEncoding >>")
        kids = []
        for page in self.pages or [_Page()]:
            content = add(stream(b"", b"\n".join(page.ops)))
            xobjects = []
            for name, pix in page.images:
                h, w = pix.shape[:2]
                num = add(stream(
                    b"/Type /XObject /Subtype /Image /Width %d /Height %d "
                    b"/ColorSpace /DeviceRGB /BitsPerComponent 8" % (w, h),
                    pix.tobytes()))
                xobjects.append(name + b" %d 0 R" % num)
            resources = b"/Font << /F1 3 0 R /F2 4 0 R >>"
            if xobjects:
                resources += b" /XObject << " + b" ".join(xobjects) + b" >>"
            kids.append(add(
                b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
                + _num(PAGE_W) + b" " + _num(PAGE_H) + b"] /Resources << "
                + resources + b" >> /Contents %d 0 R >>" % content))
        objects[1] = (b"<< /Type /Pages /Kids ["
                      + b" ".join(b"%d 0 R" % k for k in kids)
                      + b"] /Count %d >>" % len(kids))

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for k, body in enumerate(objects, start=1):
            offsets.append(len(out))
            out += b"%d 0 obj\n" % k + body + b"\nendobj\n"
        xref = len(out)
        out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
        for off in offsets:
            out += b"%010d 00000 n \n" % off
        out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
                % (len(objects) + 1, xref))
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())
