"""Minimal generation web UI served at GET / by the REST server (port of
inference/static_ui.py: the same bytes).

Parity target: ref megatron/static/index.html — a prompt textarea that
PUTs to /api and appends the completion. Kept as a Python string so the
server stays a single-module stdlib deployment.
"""

INDEX_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8"/>
<title>megatron_llm_tpu</title>
<style>
.wrapper { max-width: 75%; margin: auto; font-family: sans-serif; }
h1 { margin: 3rem 0 1rem 0; font-size: 1.5rem; }
textarea { width: 100%; min-height: 300px; border-radius: 8px;
           border: 1px solid #ddd; padding: .5rem; font-size: 1rem; }
button { margin-top: .5rem; padding: .5rem 1.5rem; border-radius: 8px;
         border: 1px solid #888; background: #f5f5f5; cursor: pointer; }
#status { margin-left: 1rem; color: #666; }
label { margin-right: 1rem; }
</style>
</head>
<body>
<div class="wrapper">
<h1>megatron_llm_tpu text generation</h1>
<textarea id="prompt" placeholder="Enter a prompt..."></textarea><br/>
<label>tokens <input id="n" type="number" value="64" min="1" style="width:5rem"/></label>
<label>top_k <input id="topk" type="number" value="1" min="0" style="width:5rem"/></label>
<label>temperature <input id="temp" type="number" value="1.0" step="0.1" style="width:5rem"/></label>
<br/>
<button onclick="gen()">Generate</button><span id="status"></span>
<script>
async function gen() {
  const t = document.getElementById('prompt');
  const status = document.getElementById('status');
  status.textContent = 'generating...';
  try {
    const resp = await fetch('/api', {
      method: 'PUT',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({
        prompts: [t.value],
        tokens_to_generate: parseInt(document.getElementById('n').value),
        top_k: parseInt(document.getElementById('topk').value),
        temperature: parseFloat(document.getElementById('temp').value),
      }),
    });
    const data = await resp.json();
    if (resp.ok) { t.value = data.text[0]; status.textContent = ''; }
    else { status.textContent = 'error: ' + JSON.stringify(data); }
  } catch (e) { status.textContent = 'error: ' + e; }
}
</script>
</div>
</body>
</html>
"""
