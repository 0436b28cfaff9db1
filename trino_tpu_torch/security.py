"""Security: identity, authentication, access control.

Analogue of the reference's security surface (SURVEY.md §2.10):
authenticators under main/server/security/ (password/JWT/insecure) and
the AccessControl SPI (spi/security/ + main/security/) with the
file-based rules plugin (plugin/trino-file-based-access-control
semantics: ordered rules, first match wins, no match denies).

Authenticators run in the coordinator HTTP front (runtime/server.py);
AccessControl checks run in the engine at statement boundaries against
the tables the plan actually reads/writes.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Identity:
    """spi/security/Identity analogue."""

    user: str
    groups: Tuple[str, ...] = ()


class AccessDeniedError(Exception):
    pass


class AuthenticationError(Exception):
    pass


# ---------------------------------------------------------------------------
# Access control (spi/security/SystemAccessControl analogue)
# ---------------------------------------------------------------------------


class AccessControl:
    """Every check raises AccessDeniedError on denial."""

    def check_can_execute_query(self, identity: Identity) -> None:
        pass

    def check_can_select(
        self, identity: Identity, catalog: str, schema: str, table: str,
        columns: Sequence[str] = (),
    ) -> None:
        pass

    def check_can_insert(
        self, identity: Identity, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_delete(
        self, identity: Identity, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_update(
        self, identity: Identity, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_create_table(
        self, identity: Identity, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_drop_table(
        self, identity: Identity, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_set_session_property(
        self, identity: Identity, name: str
    ) -> None:
        pass


class AllowAllAccessControl(AccessControl):
    """Default (main/security/AllowAllAccessControl analogue)."""


PRIVILEGES = ("SELECT", "INSERT", "DELETE", "UPDATE", "OWNERSHIP")


@dataclasses.dataclass(frozen=True)
class TableRule:
    """One file-based rule: regex match on user/catalog/schema/table,
    granting a privilege set. Missing patterns match everything."""

    privileges: Tuple[str, ...]
    user: str = ".*"
    catalog: str = ".*"
    schema: str = ".*"
    table: str = ".*"

    def matches(self, identity: Identity, catalog, schema, table) -> bool:
        return (
            re.fullmatch(self.user, identity.user) is not None
            and re.fullmatch(self.catalog, catalog) is not None
            and re.fullmatch(self.schema, schema) is not None
            and re.fullmatch(self.table, table) is not None
        )


class FileBasedAccessControl(AccessControl):
    """Ordered-rules access control: FIRST matching rule decides; no
    match denies (the reference's file-based table rules)."""

    def __init__(self, rules: Sequence[dict] | Sequence[TableRule]):
        self.rules: List[TableRule] = [
            r if isinstance(r, TableRule) else TableRule(
                tuple(p.upper() for p in r.get("privileges", ())),
                r.get("user", ".*"),
                r.get("catalog", ".*"),
                r.get("schema", ".*"),
                r.get("table", ".*"),
            )
            for r in rules
        ]

    @classmethod
    def from_file(cls, path: str) -> "FileBasedAccessControl":
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("tables", []))

    def _check(self, privilege: str, identity, catalog, schema, table):
        for rule in self.rules:
            if rule.matches(identity, catalog, schema, table):
                if privilege in rule.privileges or "OWNERSHIP" in rule.privileges:
                    return
                break  # first match decides
        raise AccessDeniedError(
            f"Access Denied: {identity.user} cannot {privilege} "
            f"{catalog}.{schema}.{table}"
        )

    def check_can_select(self, identity, catalog, schema, table, columns=()):
        self._check("SELECT", identity, catalog, schema, table)

    def check_can_insert(self, identity, catalog, schema, table):
        self._check("INSERT", identity, catalog, schema, table)

    def check_can_delete(self, identity, catalog, schema, table):
        self._check("DELETE", identity, catalog, schema, table)

    def check_can_update(self, identity, catalog, schema, table):
        self._check("UPDATE", identity, catalog, schema, table)

    def check_can_create_table(self, identity, catalog, schema, table):
        self._check("OWNERSHIP", identity, catalog, schema, table)

    def check_can_drop_table(self, identity, catalog, schema, table):
        self._check("OWNERSHIP", identity, catalog, schema, table)


# ---------------------------------------------------------------------------
# Authenticators (main/server/security/ analogues)
# ---------------------------------------------------------------------------


class Authenticator:
    def authenticate(self, headers: Dict[str, str]) -> Identity:
        raise NotImplementedError


class InsecureAuthenticator(Authenticator):
    """Trusts X-Trino-User (the reference's insecure default for
    unauthenticated HTTP)."""

    def authenticate(self, headers) -> Identity:
        return Identity(headers.get("X-Trino-User", "anonymous"))


class PasswordAuthenticator(Authenticator):
    """HTTP Basic over a salted-hash password map
    (password-file authenticator analogue). Store entries made with
    hash_password(); plaintext never lives in memory at check time."""

    def __init__(self, users: Dict[str, str]):
        """users: user -> pbkdf2$<iters>$<salt>$<hex> (see hash_password;
        legacy salt$sha256hex entries still verify)."""
        self.users = dict(users)

    @staticmethod
    def hash_password(password: str, salt: Optional[str] = None,
                      iterations: int = 100_000) -> str:
        """PBKDF2-HMAC-SHA256 with a per-user random salt (the
        reference's password-file authenticator uses bcrypt/PBKDF2;
        one unsalted SHA-256 round is brute-forceable and makes equal
        passwords visibly equal across users)."""
        import secrets

        if salt is None:
            salt = secrets.token_hex(16)
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt.encode(), iterations
        ).hex()
        return f"pbkdf2${iterations}${salt}${digest}"

    def authenticate(self, headers) -> Identity:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            raise AuthenticationError("missing Basic credentials")
        try:
            user, _, password = (
                base64.b64decode(auth[6:]).decode().partition(":")
            )
        except Exception as ex:
            raise AuthenticationError("malformed Basic credentials") from ex
        stored = self.users.get(user)
        if stored is None:
            raise AuthenticationError("unknown user")
        parts = stored.split("$")
        if parts[0] == "pbkdf2" and len(parts) == 4:
            _, iters, salt, digest = parts
            expect = hashlib.pbkdf2_hmac(
                "sha256", password.encode(), salt.encode(), int(iters)
            ).hex()
        else:  # legacy salt$sha256hex entries
            salt, _, digest = stored.partition("$")
            expect = hashlib.sha256((salt + password).encode()).hexdigest()
        if not hmac.compare_digest(expect, digest):
            raise AuthenticationError("bad password")
        return Identity(user)


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class InternalAuthenticator:
    """Shared-secret authentication for engine-internal HTTP (the
    InternalAuthenticationManager analogue): workers and coordinators
    exchange an HS256 JWT in X-Trino-Internal-Bearer. Tokens are minted
    short-lived and re-minted on expiry."""

    HEADER = "X-Trino-Internal-Bearer"

    def __init__(self, secret: str):
        self._jwt = JwtAuthenticator(secret)
        self._token: Optional[str] = None
        self._token_exp = 0.0

    def token(self) -> str:
        now = time.time()
        if self._token is None or now > self._token_exp - 30:
            self._token = self._jwt.issue("trino-internal", ttl_seconds=300)
            self._token_exp = now + 300
        return self._token

    def verify(self, headers) -> None:
        """Raises AuthenticationError when the internal bearer is
        missing or invalid."""
        tok = headers.get(self.HEADER, "")
        if not tok:
            raise AuthenticationError("missing internal bearer")
        self._jwt.authenticate({"Authorization": f"Bearer {tok}"})


class JwtAuthenticator(Authenticator):
    """Bearer JWT with HS256 (the reference's JWT authenticator reduced
    to the shared-secret HMAC form — no external crypto deps)."""

    def __init__(self, secret: str, principal_claim: str = "sub"):
        self.secret = secret.encode()
        self.principal_claim = principal_claim

    def issue(self, user: str, ttl_seconds: int = 3600) -> str:
        header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        payload = _b64url(
            json.dumps(
                {self.principal_claim: user,
                 "exp": int(time.time()) + ttl_seconds}
            ).encode()
        )
        signing_input = f"{header}.{payload}".encode()
        sig = _b64url(hmac.new(self.secret, signing_input, hashlib.sha256).digest())
        return f"{header}.{payload}.{sig}"

    def authenticate(self, headers) -> Identity:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            raise AuthenticationError("missing Bearer token")
        token = auth[7:]
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            signing_input = f"{header_b64}.{payload_b64}".encode()
            expect = hmac.new(
                self.secret, signing_input, hashlib.sha256
            ).digest()
            if not hmac.compare_digest(expect, _b64url_dec(sig_b64)):
                raise AuthenticationError("bad signature")
            payload = json.loads(_b64url_dec(payload_b64))
        except AuthenticationError:
            raise
        except Exception as ex:
            raise AuthenticationError("malformed token") from ex
        if payload.get("exp") is not None and payload["exp"] < time.time():
            raise AuthenticationError("token expired")
        user = payload.get(self.principal_claim)
        if not user:
            raise AuthenticationError("no principal claim")
        return Identity(str(user))
