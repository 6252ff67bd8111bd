"""Seeded request-id-origin violations: minting or
literal-constructing request ids outside the sanctioned origin
(serve/request.py) forks the per-request trace."""

import os
import secrets
import uuid


def mint_with_uuid():
    return uuid.uuid4().hex  # expect: request-id-origin


def mint_with_urandom():
    return os.urandom(8).hex()  # expect: request-id-origin


def mint_with_token_hex():
    return secrets.token_hex(8)  # expect: request-id-origin


def rebuild_id(base, attempt, submit):
    payload = {"request_id": f"{base}-{attempt}"}  # expect: request-id-origin
    payload["request_id"] = base + "-retry"  # expect: request-id-origin
    submit(request_id="manual-001")  # expect: request-id-origin
    return payload
