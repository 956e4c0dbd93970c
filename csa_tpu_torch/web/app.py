"""Web frontend: upload a circular multi-FASTA, rotate, browse results
(the port's copy of :mod:`csa_tpu.web.app`, whose jobs run the port's
CLI, ``python -m csa_tpu_torch.cli R``, on the server's ``--device``).

Behavioral equivalent of the reference's PHP frontend
(the reference's ``website/index.php``): upload form (file or pasted
text, 5 MB / 64-sequence caps), runs the rotation pipeline with a
wall-clock timeout (index.php:353 ``timeout -s 9 1h ./CSA R``), streams
the console narrative, renders the block map image with a clickable
image map (parsed from ``-imagemap.txt``), a sortable positions table
(parsed from ``-positions.txt``), download buttons, a 48-hour upload
GC (index.php:298-316), and a request log (index.php:138-141).

Stdlib-only (``http.server``); run with

    python -m csa_tpu_torch.web.app [PORT] [--device cuda|cpu]

(port 8080 and ``cuda`` by default; the jobs run on the CPU only when
asked for with ``--device cpu``).  Uploads go to ``CSA_TPU_UPLOAD_DIR``,
by default a directory under the system's temporary directory.
"""

from __future__ import annotations

import argparse
import html
import os
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.parse
from email.parser import BytesParser
from email.policy import default as email_default
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MAX_UPLOAD = 5 * 1024 * 1024  # 5 MB (index.php upload cap)
MAX_SEQS = 64
GC_SECONDS = 48 * 3600
RUN_TIMEOUT = 3600.0

UPLOAD_DIR = os.environ.get(
    "CSA_TPU_UPLOAD_DIR",
    os.path.join(tempfile.gettempdir(), "csa_tpu_torch_uploads"))
LOG_FILE = os.path.join(UPLOAD_DIR, "requests.log")

PAGE = """<!DOCTYPE html>
<html><head><title>csa-tpu-torch — Multiple Circular Sequence Aligner</title>
<style>
body {{ font-family: sans-serif; margin: 2em; max-width: 70em; }}
textarea {{ width: 100%; }}
pre.console {{ background: #111; color: #ddd; padding: 1em; overflow-x: auto; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 0.2em 0.6em; }}
th {{ cursor: pointer; background: #eee; }}
</style></head><body>
<h1>csa-tpu-torch — Multiple Circular Sequence Aligner</h1>
<form method="post" action="/run" enctype="multipart/form-data">
<p>FASTA file (max 5 MB, 2&ndash;64 circular DNA sequences):
<input type="file" name="fastafile"></p>
<p>&hellip;or paste sequences:</p>
<p><textarea name="fastatext" rows="8"></textarea></p>
<p>Minimum block size: <input name="minblocksize" value="10" size="4">
<input type="submit" value="Rotate"></p>
</form>
{body}
<script>
function sortTable(t, col) {{
  var rows = Array.from(t.tBodies[0].rows);
  var dir = t.dataset.dir === 'a' ? -1 : 1;
  t.dataset.dir = dir === 1 ? 'a' : 'd';
  rows.sort(function(r1, r2) {{
    var a = r1.cells[col].innerText, b = r2.cells[col].innerText;
    var na = parseFloat(a), nb = parseFloat(b);
    if (!isNaN(na) && !isNaN(nb)) return (na - nb) * dir;
    return a.localeCompare(b) * dir;
  }});
  rows.forEach(function(r) {{ t.tBodies[0].appendChild(r); }});
}}
document.querySelectorAll('table.sortable th').forEach(function(th, i) {{
  th.addEventListener('click', function() {{
    sortTable(th.closest('table'), th.cellIndex);
  }});
}});
</script>
</body></html>"""


def _gc_uploads() -> None:
    now = time.time()
    if not os.path.isdir(UPLOAD_DIR):
        return
    for name in os.listdir(UPLOAD_DIR):
        p = os.path.join(UPLOAD_DIR, name)
        try:
            st = os.stat(p)
            if now - st.st_mtime > GC_SECONDS or st.st_size > MAX_UPLOAD * 4:
                os.unlink(p)
        except OSError:
            pass


def _log_request(addr: str, note: str) -> None:
    os.makedirs(UPLOAD_DIR, exist_ok=True)
    with open(LOG_FILE, "a") as f:
        f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')}\t{addr}\t{note}\n")


def run_rotation_job(fasta_path: str, minblocksize: int = 10, *,
                     device: str = "cuda") -> dict:
    """Run the R-mode pipeline of the port's CLI on ``device`` on an
    uploaded file; returns artifacts.

    The pipeline runs in a child process killed after ``RUN_TIMEOUT``
    seconds — the analog of the reference frontend's
    ``timeout -s 9 1h ./CSA R <file>`` (index.php:353): a wedged or
    adversarial input can never tie up the server thread indefinitely.
    """
    from ..cli import output_filename

    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "csa_tpu_torch.cli", "R", fasta_path,
             "--min-block-size", str(minblocksize), "--device", device],
            capture_output=True,
            text=True,
            timeout=RUN_TIMEOUT,
        )
    except subprocess.TimeoutExpired:
        raise ValueError(
            f"processing exceeded the {int(RUN_TIMEOUT)} s time limit"
        )
    log = proc.stdout + (("\n" + proc.stderr) if proc.returncode else "")
    if proc.returncode != 0:
        # surface the pipeline's own error line, like the PHP page streams
        # the CLI's stdout/stderr
        lines = [ln for ln in log.splitlines() if "ERROR" in ln]
        raise ValueError(lines[-1] if lines else "rotation pipeline failed")
    rotfile = output_filename(fasta_path, "-Rotated.fasta")
    return {
        "log": log,
        "elapsed": time.time() - t0,
        "rotated": rotfile,
        "image": output_filename(fasta_path, "-Blocks.bmp"),
        "imagemap": output_filename(fasta_path, "-imagemap.txt"),
        "positions": output_filename(fasta_path, "-positions.txt"),
        "csv": output_filename(fasta_path, "-Blocks.csv"),
    }


def _imagemap_areas(path: str) -> str:
    """Build a real ``<map name="blocksmap">`` element from the
    ``-imagemap.txt`` data file (lines: seq x0 y0 x1 y1 size rotated),
    like the reference PHP parses its map data into ``<area>`` tags
    (the reference's website/index.php:383-405).  Clicking a block jumps
    to (and highlights) its track's row region in the positions table.
    """
    if not os.path.exists(path):
        return ""
    areas = []
    row = -1
    with open(path) as f:
        f.readline()  # "width height" header
        for line in f:
            parts = line.split()
            if len(parts) != 7:
                continue
            seq, x0, y0, x1, y1, size, rotated = (int(v) for v in parts)
            if seq == 0:
                row += 1  # each drawn chain emits its k areas seq-0-first
            title = (
                f"sequence {seq + 1}: block size {size} at rotated "
                f"position {rotated}"
            )
            areas.append(
                f'<area shape="rect" coords="{x0},{y0},{max(x0, x1)},{y1}" '
                f'href="#row{max(row, 0)}" title="{html.escape(title)}" '
                f'alt="{html.escape(title)}">'
            )
    if not areas:
        return ""
    return '<map name="blocksmap" id="blocksmap">' + "".join(areas) + "</map>"


def _render_results(job: dict, token: str) -> str:
    out = ["<hr><h2>Results</h2>"]
    out.append(f"<pre class=console>{html.escape(job['log'])}</pre>")
    # image with a clickable map built from the imagemap data file
    out.append(_imagemap_areas(job["imagemap"]))
    out.append(
        f'<p><img src="/file?t={token}&k=image" usemap="#blocksmap" '
        f'alt="block map"></p>'
    )
    # positions table (rows carry ids the image-map areas link to)
    if os.path.exists(job["positions"]):
        rows = [
            line.split()
            for line in open(job["positions"])
            if line.strip()
        ]
        if rows:
            k = int(rows[0][0]) if rows[0] and rows[0][0].isdigit() else 0
            out.append('<table class="sortable"><thead><tr>')
            header = ["R", "G", "B", "Size"] + [
                f"Position_{i + 1}" for i in range(k)
            ]
            for cell in header:
                out.append(f"<th>{html.escape(cell)}</th>")
            out.append("</tr></thead><tbody>")
            for ri, row in enumerate(rows[1:]):
                out.append(
                    f'<tr id="row{ri}">'
                    + "".join(f"<td>{html.escape(c)}</td>" for c in row)
                    + "</tr>"
                )
            out.append("</tbody></table>")
    for key, label in (
        ("rotated", "Rotated FASTA"),
        ("csv", "Blocks CSV"),
        ("image", "Block map BMP"),
    ):
        out.append(
            f'<p><a href="/file?t={token}&k={key}">Download {label}</a></p>'
        )
    out.append(f"<p>Processed in {job['elapsed']:.2f} s</p>")
    return "".join(out)


class Handler(BaseHTTPRequestHandler):
    """The frontend's requests; :func:`make_handler` gives a server its
    own, with the device its jobs run on and its own table of jobs."""

    jobs: dict = {}
    device: str = "cuda"

    def _send_page(self, body: str, code: int = 200):
        data = PAGE.format(body=body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path == "/":
            self._send_page("")
            return
        if url.path == "/file":
            q = urllib.parse.parse_qs(url.query)
            token = q.get("t", [""])[0]
            key = q.get("k", [""])[0]
            job = self.jobs.get(token)
            path = job.get(key) if job else None
            if not path or not os.path.exists(path):
                self.send_error(404)
                return
            ctype = "image/bmp" if path.endswith(".bmp") else "text/plain"
            with open(path, "rb") as f:
                data = f.read()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header(
                "Content-Disposition",
                f'attachment; filename="{os.path.basename(path)}"'
                if ctype == "text/plain" else "inline",
            )
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self.send_error(404)

    def do_POST(self):
        if self.path != "/run":
            self.send_error(404)
            return
        _gc_uploads()
        length = int(self.headers.get("Content-Length", "0"))
        if length > MAX_UPLOAD:
            self._send_page("<p><b>ERROR:</b> upload exceeds 5 MB</p>", 413)
            return
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        data = b""
        minblock = 10
        if "multipart/form-data" in ctype:
            msg = BytesParser(policy=email_default).parsebytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
            )
            for part in msg.iter_parts():
                name = part.get_param(
                    "name", header="content-disposition"
                )
                payload = part.get_payload(decode=True) or b""
                if name == "fastafile" and payload:
                    data = payload
                elif name == "fastatext" and payload.strip() and not data:
                    data = payload
                elif name == "minblocksize":
                    try:
                        minblock = int(payload.decode().strip() or "10")
                    except ValueError:
                        pass
        if not data.strip():
            self._send_page("<p><b>ERROR:</b> no sequences provided</p>", 400)
            return
        os.makedirs(UPLOAD_DIR, exist_ok=True)
        token = f"{int(time.time())}_{os.getpid()}_{len(self.jobs)}"
        path = os.path.join(UPLOAD_DIR, f"u{token}.fasta")
        with open(path, "wb") as f:
            f.write(data)
        _log_request(self.client_address[0], f"run {path} ({len(data)} B)")
        try:
            job = run_rotation_job(path, minblock, device=self.device)
        except Exception as e:  # surface pipeline errors like the PHP page
            self._send_page(
                f"<p><b>ERROR:</b> {html.escape(str(e))}</p>"
                f"<pre>{html.escape(traceback.format_exc(limit=3))}</pre>",
                500,
            )
            return
        self.jobs[token] = job
        self._send_page(_render_results(job, token))

    def log_message(self, fmt, *args):  # quiet default logging
        pass


def make_handler(device: str = "cuda"):
    """A request handler class whose jobs run on ``device``."""
    return type("CsaHandler", (Handler,), {"device": device, "jobs": {}})


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m csa_tpu_torch.web.app",
        description="Upload frontend of the PyTorch/CUDA port")
    parser.add_argument("port", nargs="?", type=int, default=8080)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the rotation jobs "
                             "(default cuda)")
    args = parser.parse_args(argv)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(args.device))
    print(f"csa-tpu-torch web frontend on http://localhost:{args.port}/ "
          f"(jobs on {args.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
