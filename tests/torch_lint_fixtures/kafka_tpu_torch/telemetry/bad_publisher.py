"""Seeded violations: blocking outbound calls inside the telemetry
publisher/httpd tree (``blocking-call-in-publisher``).  The
heartbeat/endpoint threads run in every process — an unbounded HTTP
fetch, raw socket connect or subprocess there stalls the heartbeat and
reads as a dead host."""

import socket
import subprocess
from urllib.request import urlopen

import requests


def scrape_peer(url):
    return requests.get(url)  # expect: blocking-call-in-publisher


def dial(host):
    return socket.create_connection((host, 80))  # expect: blocking-call-in-publisher


def raw_socket():
    return socket.socket()  # expect: blocking-call-in-publisher


def shell_out():
    return subprocess.check_output(["hostname"])  # expect: blocking-call-in-publisher


def fetch(url):
    return urlopen(url)  # expect: blocking-call-in-publisher


def identity_is_fine():
    # Local and non-blocking: the snapshot's identity field.
    return socket.gethostname()
