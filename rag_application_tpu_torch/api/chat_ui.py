"""Single-file chat UI served at GET /chat (L7 parity).

Copy of `rag_application_tpu/api/chat_ui.py`.

The reference ships a vendored Next.js LangGraph chat frontend
(AgentChatUI/agent-chat-ui/package.json:1-24) that talks to the agent
API. This is the native equivalent at the same API boundary: one static
HTML page — no build step, no dependencies — that drives the
OpenAI-compatible `/v1/chat/completions` SSE stream (agent mode uses
`/chat/completions`, the knowledge-tools agent route) with fetch +
ReadableStream and renders the conversation. Agent-mode threads are
SERVER-SIDE: the page lists/loads/deletes them through
`/chat/threads[/{id}]` (backed by the same ThreadCheckpointer that
powers agent resume), so conversations survive page reloads — the
parity point with the reference's LangGraph-SDK thread persistence.
Plain OpenAI mode stays stateless client-side, like the API it calls.
An optional bearer key (localStorage) covers deployments started with
an API key.
"""

CHAT_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>rag_application_tpu — chat</title>
<style>
  :root { color-scheme: light dark;
          --bg: #f6f7f9; --fg: #1a1d21; --card: #ffffff; --line: #d9dde3;
          --accent: #3b6ef5; --muted: #6b7380; }
  @media (prefers-color-scheme: dark) {
    :root { --bg: #16181c; --fg: #e8eaed; --card: #1f2228;
            --line: #33373e; --accent: #7aa2ff; --muted: #9aa1ab; } }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--bg); color: var(--fg);
         font: 15px/1.5 system-ui, sans-serif;
         display: flex; flex-direction: column; height: 100vh; }
  header { display: flex; gap: .6rem; align-items: center;
           padding: .6rem 1rem; border-bottom: 1px solid var(--line);
           background: var(--card); flex-wrap: wrap; }
  header h1 { font-size: 1rem; margin: 0; font-weight: 600; }
  header .spacer { flex: 1; }
  select, input[type=password] {
    background: var(--bg); color: var(--fg); border: 1px solid var(--line);
    border-radius: 6px; padding: .3rem .5rem; font: inherit; }
  label.sw { display: flex; align-items: center; gap: .3rem;
             color: var(--muted); font-size: .85rem; }
  #log { flex: 1; overflow-y: auto; padding: 1rem;
         display: flex; flex-direction: column; gap: .75rem; }
  .msg { max-width: 46rem; padding: .55rem .8rem; border-radius: 10px;
         white-space: pre-wrap; word-break: break-word; }
  .user { align-self: flex-end; background: var(--accent); color: #fff; }
  .assistant { align-self: flex-start; background: var(--card);
               border: 1px solid var(--line); }
  .error { align-self: center; color: #c0392b; font-size: .85rem; }
  form { display: flex; gap: .6rem; padding: .8rem 1rem;
         border-top: 1px solid var(--line); background: var(--card); }
  #q { flex: 1; resize: none; font: inherit; background: var(--bg);
       color: var(--fg); border: 1px solid var(--line); border-radius: 8px;
       padding: .55rem .8rem; }
  button { background: var(--accent); color: #fff; border: 0;
           border-radius: 8px; padding: 0 1.1rem; font: inherit;
           cursor: pointer; }
  button:disabled { opacity: .5; cursor: default; }
</style>
</head>
<body>
<header>
  <h1>rag_application_tpu</h1>
  <span class="spacer"></span>
  <label class="sw"><input type="checkbox" id="agent"> knowledge agent</label>
  <select id="thread" title="thread (agent mode)">
    <option value="">new thread</option>
  </select>
  <button id="delthread" type="button" title="delete thread">&#x2715;</button>
  <select id="model" title="model"><option>loading…</option></select>
  <input type="password" id="key" placeholder="API key (optional)" size="14">
</header>
<div id="log"></div>
<form id="f">
  <textarea id="q" rows="2" placeholder="Ask something…  (Enter to send,
Shift+Enter for a newline)"></textarea>
  <button id="send" type="submit">Send</button>
</form>
<script>
"use strict";
const log = document.getElementById("log");
const form = document.getElementById("f");
const q = document.getElementById("q");
const send = document.getElementById("send");
const modelSel = document.getElementById("model");
const keyInput = document.getElementById("key");
const agentSw = document.getElementById("agent");
const history = [];
keyInput.value = localStorage.getItem("ragtpu_key") || "";
keyInput.addEventListener("change",
  () => localStorage.setItem("ragtpu_key", keyInput.value));

function headers() {
  const h = {"content-type": "application/json"};
  if (keyInput.value) h["authorization"] = "Bearer " + keyInput.value;
  return h;
}

function bubble(cls, text) {
  const d = document.createElement("div");
  d.className = "msg " + cls;
  d.textContent = text;
  log.appendChild(d);
  log.scrollTop = log.scrollHeight;
  return d;
}

async function loadModels() {
  try {
    const r = await fetch("/v1/models", {headers: headers()});
    const data = await r.json();
    modelSel.innerHTML = "";
    for (const m of (data.data || [])) {
      const o = document.createElement("option");
      o.value = o.textContent = m.id;
      modelSel.appendChild(o);
    }
  } catch (e) { modelSel.innerHTML = "<option>default</option>"; }
}
loadModels();

// --- server-side threads (agent mode): the conversation persists in
// the ThreadCheckpointer behind GET/DELETE /chat/threads — reload the
// page, pick the thread, continue where you left off.
const threadSel = document.getElementById("thread");
const delThread = document.getElementById("delthread");
let threadId = null;   // null = fresh; assigned client-side on first send

function newThreadId() {
  const hex = [...crypto.getRandomValues(new Uint8Array(6))]
    .map(b => b.toString(16).padStart(2, "0")).join("");
  return "chat-" + hex;
}

async function loadThreads(keep) {
  try {
    const r = await fetch("/chat/threads", {headers: headers()});
    const data = await r.json();
    threadSel.innerHTML = "<option value=''>new thread</option>";
    for (const t of (data.threads || [])) {
      const o = document.createElement("option");
      o.value = t.thread_id;
      o.textContent = (t.title || t.thread_id).slice(0, 40);
      threadSel.appendChild(o);
    }
    threadSel.value = keep || "";
  } catch (e) { /* endpoint may be auth-gated; selector stays empty */ }
}
loadThreads();

threadSel.addEventListener("change", async () => {
  log.innerHTML = "";
  history.length = 0;
  threadId = threadSel.value || null;
  if (!threadId) return;
  try {
    const r = await fetch("/chat/threads/" + threadId,
                          {headers: headers()});
    const data = await r.json();
    for (const m of (data.messages || [])) {
      bubble(m.role === "user" ? "user" : "assistant", m.content);
      history.push({role: m.role, content: m.content});
    }
  } catch (e) { bubble("error", String(e)); }
});

delThread.addEventListener("click", async () => {
  if (!threadId) { log.innerHTML = ""; history.length = 0; return; }
  await fetch("/chat/threads/" + threadId,
              {method: "DELETE", headers: headers()});
  threadId = null;
  log.innerHTML = "";
  history.length = 0;
  loadThreads();
});

async function ask(text) {
  history.push({role: "user", content: text});
  bubble("user", text);
  const out = bubble("assistant", "");
  send.disabled = true;
  try {
    const url = agentSw.checked ? "/chat/completions"
                                : "/v1/chat/completions";
    const isNewThread = agentSw.checked && !threadId;
    if (isNewThread) threadId = newThreadId();
    const body = {model: modelSel.value || "default",
                  messages: history, stream: true};
    if (agentSw.checked) body.thread_id = threadId;
    const r = await fetch(url, {
      method: "POST", headers: headers(),
      body: JSON.stringify(body),
    });
    if (!r.ok) throw new Error("HTTP " + r.status + " " + await r.text());
    const reader = r.body.getReader();
    const dec = new TextDecoder();
    let buf = "", acc = "";
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      const frames = buf.split("\\n\\n");
      buf = frames.pop();
      for (const frame of frames) {
        for (const line of frame.split("\\n")) {
          if (!line.startsWith("data:")) continue;
          const payload = line.slice(5).trim();
          if (payload === "[DONE]") continue;
          try {
            const delta = JSON.parse(payload).choices?.[0]?.delta?.content;
            if (delta) { acc += delta; out.textContent = acc; }
          } catch (e) { /* partial frame */ }
          log.scrollTop = log.scrollHeight;
        }
      }
    }
    history.push({role: "assistant", content: acc});
    if (agentSw.checked) loadThreads(threadId);
  } catch (e) {
    out.remove();
    bubble("error", String(e));
    history.pop();
  } finally {
    send.disabled = false;
    q.focus();
  }
}

form.addEventListener("submit", (ev) => {
  ev.preventDefault();
  const text = q.value.trim();
  if (!text || send.disabled) return;
  q.value = "";
  ask(text);
});
q.addEventListener("keydown", (ev) => {
  if (ev.key === "Enter" && !ev.shiftKey) {
    ev.preventDefault();
    form.requestSubmit();
  }
});
</script>
</body>
</html>
"""
