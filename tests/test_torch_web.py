"""The port's web frontend (csa_tpu_torch.web.app): upload -> rotate ->
artifacts over real HTTP, its jobs running the port's CLI on the CPU
(modelled on tests/test_web.py)."""

import http.client
import pathlib
import re
import threading
import urllib.error
import urllib.request
import uuid
from http.server import ThreadingHTTPServer

import pytest

from csa_tpu_torch.web import app as webapp

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    upload = tmp_path_factory.mktemp("uploads")
    saved = webapp.UPLOAD_DIR, webapp.LOG_FILE
    webapp.UPLOAD_DIR = str(upload)
    webapp.LOG_FILE = str(upload / "requests.log")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), webapp.make_handler("cpu"))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    t.join(timeout=30)
    webapp.UPLOAD_DIR, webapp.LOG_FILE = saved


def test_upload_and_results(server):
    boundary = uuid.uuid4().hex
    fasta = (FIXTURES / "tiny" / "t1.txt").read_bytes()
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; '
        f'name="fastafile"; filename="t1.txt"\r\n'
        f"Content-Type: text/plain\r\n\r\n"
    ).encode() + fasta + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        server + "/run", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    text = urllib.request.urlopen(req, timeout=120).read().decode()
    assert "Results" in text
    assert "Download Rotated FASTA" in text
    assert "csa-tpu-torch" in text   # the port's CLI ran the job
    # a clickable block map: <area> tags whose hrefs land on rows of the
    # positions table
    assert '<map name="blocksmap"' in text
    assert "<area " in text
    hrefs = set(re.findall(r'href="#(row\d+)"', text))
    ids = set(re.findall(r'<tr id="(row\d+)"', text))
    assert hrefs and hrefs <= ids
    m = re.search(r"/file\?t=([^&\"]+)&k=rotated", text)
    assert m
    rot = urllib.request.urlopen(
        server + f"/file?t={m.group(1)}&k=rotated", timeout=30
    ).read().decode()
    assert "@ 74" in rot  # s0's captured reference rotation
    assert (FIXTURES / "tiny" / "t1-Rotated.fasta").read_text() == rot
    log = pathlib.Path(webapp.LOG_FILE).read_text()
    assert "\trun " in log


def test_form_page(server):
    page = urllib.request.urlopen(server + "/", timeout=30).read().decode()
    assert "fastafile" in page and "minblocksize" in page


def test_rejects_empty(server):
    req = urllib.request.Request(
        server + "/run", data=b"", headers={"Content-Type": "text/plain"}
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_rejects_oversized_upload(server):
    """The 5 MB cap, read from the request's length before its body."""
    host, port = server.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/run")
        conn.putheader("Content-Type", "text/plain")
        conn.putheader("Content-Length", str(webapp.MAX_UPLOAD + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert b"exceeds 5 MB" in resp.read()
    finally:
        conn.close()


def test_job_runs_the_port_cli_on_its_device(monkeypatch, tmp_path):
    """The job's child is the port's CLI with the server's device, under
    the one-hour kill."""
    seen = {}

    class Done:
        returncode = 0
        stdout = "> Done!\n"
        stderr = ""

    def fake_run(argv, **kw):
        seen.update(argv=argv, timeout=kw.get("timeout"))
        return Done()

    monkeypatch.setattr(webapp.subprocess, "run", fake_run)
    job = webapp.run_rotation_job(str(tmp_path / "u.fasta"), 12,
                                  device="cuda")
    assert seen["argv"][1:] == ["-m", "csa_tpu_torch.cli", "R",
                                str(tmp_path / "u.fasta"),
                                "--min-block-size", "12", "--device", "cuda"]
    assert seen["timeout"] == webapp.RUN_TIMEOUT == 3600.0
    assert job["rotated"] == str(tmp_path / "u-Rotated.fasta")
