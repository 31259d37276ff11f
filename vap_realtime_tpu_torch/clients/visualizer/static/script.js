// VAP offline visualizer: canvas waveforms + probability charts with a
// playback cursor synced to the <audio> elements (reference analogue:
// output/offline_prediction_visualizer/static/script.js).
"use strict";

const $ = (id) => document.getElementById(id);
const audioL = $("audioL"), audioR = $("audioR");
let rows = [];           // [t, pnow0, pnow1, pfut0, pfut1]
let waves = {};          // channel -> Float32Array (downsampled peaks)
let duration = 0;

async function decodeWave(url, canvasId) {
  const ctx = new (window.AudioContext || window.webkitAudioContext)();
  const buf = await (await fetch(url)).arrayBuffer();
  const audio = await ctx.decodeAudioData(buf);
  duration = Math.max(duration, audio.duration);
  const data = audio.getChannelData(0);
  const n = 2000, peaks = new Float32Array(n);
  const step = Math.floor(data.length / n);
  for (let i = 0; i < n; i++) {
    let m = 0;
    for (let j = i * step; j < (i + 1) * step; j += 8)
      m = Math.max(m, Math.abs(data[j]));
    peaks[i] = m;
  }
  waves[canvasId] = peaks;
}

function drawWave(canvasId) {
  const c = $(canvasId), g = c.getContext("2d");
  c.width = c.clientWidth;
  g.clearRect(0, 0, c.width, c.height);
  const peaks = waves[canvasId];
  if (!peaks) return;
  g.fillStyle = "#345";
  const mid = c.height / 2;
  for (let i = 0; i < peaks.length; i++) {
    const x = i / peaks.length * c.width;
    const h = peaks[i] * mid;
    g.fillRect(x, mid - h, Math.max(c.width / peaks.length - .5, .5), 2 * h);
  }
  drawCursor(c, g);
}

function drawProb(canvasId, colLeft, colRight) {
  const c = $(canvasId), g = c.getContext("2d");
  c.width = c.clientWidth;
  g.clearRect(0, 0, c.width, c.height);
  if (!rows.length) return;
  const mid = c.height / 2;
  g.strokeStyle = "#bbb"; g.beginPath();
  g.moveTo(0, mid); g.lineTo(c.width, mid); g.stroke();
  for (let i = 0; i < rows.length; i++) {
    const x = rows[i][0] / duration * c.width;
    const p = rows[i][colRight];           // P(ch2 next)
    const w = Math.max(c.width / rows.length, 1);
    if (p >= 0.5) {
      g.fillStyle = "rgba(255,140,0,.8)";
      g.fillRect(x, mid - (p - 0.5) * c.height, w, (p - 0.5) * c.height);
    } else {
      g.fillStyle = "rgba(70,130,180,.8)";
      g.fillRect(x, mid, w, (0.5 - p) * c.height);
    }
  }
  drawCursor(c, g);
}

function drawCursor(c, g) {
  if (!duration) return;
  const x = audioL.currentTime / duration * c.width;
  g.strokeStyle = "red"; g.lineWidth = 1;
  g.beginPath(); g.moveTo(x, 0); g.lineTo(x, c.height); g.stroke();
}

function redraw() {
  drawWave("wave1"); drawWave("wave2");
  drawProb("pnow", 1, 2); drawProb("pfut", 3, 4);
  $("time").textContent = audioL.currentTime.toFixed(2) + " s";
  requestAnimationFrame(redraw);
}

function togglePlay() {
  if (audioL.paused) { audioL.play(); audioR.play(); }
  else { audioL.pause(); audioR.pause(); }
}

function setSpeed(r) {
  audioL.playbackRate = r; audioR.playbackRate = r;
  $("speed").textContent = "x" + r;
}

$("play").onclick = togglePlay;
document.addEventListener("keydown", (e) => {
  if (e.code === "Space") { e.preventDefault(); togglePlay(); }
  if (e.key === "1") setSpeed(0.5);
  if (e.key === "2") setSpeed(1.0);
  if (e.key === "3") setSpeed(2.0);
});
// click-to-seek on any canvas
for (const id of ["wave1", "wave2", "pnow", "pfut"])
  $(id).addEventListener("click", (e) => {
    const frac = e.offsetX / e.target.clientWidth;
    audioL.currentTime = audioR.currentTime = frac * duration;
  });

(async () => {
  rows = await (await fetch("/data")).json();
  await decodeWave("/audio/left", "wave1");
  await decodeWave("/audio/right", "wave2");
  redraw();
})();
