"""User + agent-config registries with token auth.

Copy of `rag_application_tpu/api/users.py`.

Parity: the v1 monolith's user endpoints — signup/signin with hashed
passwords and bearer tokens, plus user CRUD (app/api/v1/endpoints/
user.py:28-198) — and agent CRUD (agent.py:13-64). The reference stores
these in Postgres; here a host-side registry with PBKDF2 password
hashing and HMAC-signed tokens (stdlib only), durable via to_state/
from_state like the rest of the host state.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_PBKDF2_ITERS = 100_000


def _hash_password(password: str, salt: bytes) -> str:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                               _PBKDF2_ITERS).hex()


@dataclass
class UserRecord:
    user_id: str
    username: str
    email: str
    salt: str
    password_hash: str
    created_at: float = field(default_factory=time.time)
    is_active: bool = True

    def public(self) -> Dict[str, Any]:
        return {"user_id": self.user_id, "username": self.username,
                "email": self.email, "is_active": self.is_active,
                "created_at": self.created_at}


class UserRegistry:
    def __init__(self, *, token_secret: Optional[str] = None,
                 token_ttl: float = 86400.0):
        self._users: Dict[str, UserRecord] = {}
        self._by_name: Dict[str, str] = {}
        self._secret = (token_secret or secrets.token_hex(16)).encode()
        self.token_ttl = token_ttl

    # ------------------------------------------------------------- accounts

    def signup(self, username: str, password: str, email: str = "") -> Dict:
        if username in self._by_name:
            raise ValueError(f"username {username!r} taken")
        salt = secrets.token_bytes(16)
        user_id = secrets.token_hex(8)
        rec = UserRecord(user_id=user_id, username=username, email=email,
                         salt=salt.hex(),
                         password_hash=_hash_password(password, salt))
        self._users[user_id] = rec
        self._by_name[username] = user_id
        return rec.public()

    # ---------------------------------------------------------- durability

    def to_state(self) -> Dict[str, Any]:
        """Serializable snapshot (serve.py persists it alongside the
        space checkpoints so accounts — and the token secret, hence
        outstanding tokens — survive a restart)."""
        from dataclasses import asdict

        return {"secret": self._secret.decode(),
                "token_ttl": self.token_ttl,
                "users": [asdict(u) for u in self._users.values()]}

    def from_state(self, state: Dict[str, Any]) -> None:
        self._secret = str(state["secret"]).encode()
        self.token_ttl = float(state.get("token_ttl", self.token_ttl))
        self._users = {u["user_id"]: UserRecord(**u)
                       for u in state.get("users", [])}
        self._by_name = {u.username: uid for uid, u in self._users.items()}

    def signin(self, username: str, password: str) -> Optional[str]:
        """Returns a signed bearer token or None."""
        user_id = self._by_name.get(username)
        if user_id is None:
            return None
        rec = self._users[user_id]
        if not rec.is_active:
            return None
        expect = _hash_password(password, bytes.fromhex(rec.salt))
        if not hmac.compare_digest(expect, rec.password_hash):
            return None
        payload = f"{user_id}:{int(time.time() + self.token_ttl)}"
        sig = hmac.new(self._secret, payload.encode(), "sha256").hexdigest()
        return f"{payload}:{sig}"

    def verify_token(self, token: str) -> Optional[str]:
        """Returns the user_id for a valid unexpired token."""
        try:
            user_id, expiry, sig = token.rsplit(":", 2)
        except ValueError:
            return None
        payload = f"{user_id}:{expiry}"
        expect = hmac.new(self._secret, payload.encode(), "sha256").hexdigest()
        if not hmac.compare_digest(expect, sig):
            return None
        if time.time() > int(expiry):
            return None
        rec = self._users.get(user_id)
        # deactivation must REVOKE access, not just block new signins —
        # an is_active=false user's outstanding tokens stop working now
        if rec is None or not rec.is_active:
            return None
        return user_id

    # ----------------------------------------------------------------- CRUD

    def list(self) -> List[Dict]:
        return [u.public() for u in self._users.values()]

    def get(self, user_id: str) -> Optional[Dict]:
        rec = self._users.get(user_id) or self._users.get(
            self._by_name.get(user_id, ""))
        return rec.public() if rec else None

    def update(self, user_id: str, **fields) -> Optional[Dict]:
        rec = self._users.get(user_id)
        if rec is None:
            return None
        if "email" in fields:
            rec.email = fields["email"]
        if "is_active" in fields:
            rec.is_active = bool(fields["is_active"])
        if "password" in fields:
            salt = secrets.token_bytes(16)
            rec.salt = salt.hex()
            rec.password_hash = _hash_password(fields["password"], salt)
        return rec.public()

    def delete(self, user_id: str) -> bool:
        rec = self._users.pop(user_id, None)
        if rec:
            self._by_name.pop(rec.username, None)
            return True
        return False


class AgentConfigRegistry:
    """Custom agent configurations (parity: agent CRUD, agent.py:13-64 +
    the capability-toggled catalog, AgentAPI backend/agents/catalog.py)."""

    def __init__(self):
        self._agents: Dict[str, Dict[str, Any]] = {}
        self._counter = 0

    def to_state(self) -> Dict[str, Any]:
        return {"agents": list(self._agents.values()),
                "counter": self._counter}

    def from_state(self, state: Dict[str, Any]) -> None:
        self._agents = {a["agent_id"]: dict(a)
                        for a in state.get("agents", [])}
        self._counter = int(state.get("counter", len(self._agents)))

    def create(self, name: str, *, base: str = "chat_agent",
               system_prompt: str = "", capabilities: Optional[Dict] = None
               ) -> Dict[str, Any]:
        from ..agents import get_agent_by_id

        if get_agent_by_id(base) is None:
            raise ValueError(f"unknown base agent {base!r}")
        self._counter += 1
        agent_id = f"custom-{self._counter}"
        cfg = {"agent_id": agent_id, "name": name, "base": base,
               "system_prompt": system_prompt,
               "capabilities": capabilities or {"tools": True, "memory": True}}
        self._agents[agent_id] = cfg
        return cfg

    def list(self) -> List[Dict]:
        return list(self._agents.values())

    def get(self, agent_id: str) -> Optional[Dict]:
        return self._agents.get(agent_id)

    def update(self, agent_id: str, **fields) -> Optional[Dict]:
        cfg = self._agents.get(agent_id)
        if cfg is None:
            return None
        for k in ("name", "system_prompt", "capabilities"):
            if k in fields and fields[k] is not None:
                cfg[k] = fields[k]
        return cfg

    def delete(self, agent_id: str) -> bool:
        return self._agents.pop(agent_id, None) is not None
