#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line:

1. device   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build    — the port's CUDA kernels compiled from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all at once);
3. paged_decode_attention — the kernel at granite-8b widths (M=8, H=32,
   Hk=8, hd=128, page 32) over ragged lengths with poisoned stale pages,
   fp32 and int8, against ``paged_attention_plain`` on the card (1e-4),
   and over ``PAGED_CASES``: lengths either side of the split pass's
   4-page splits, one slot at 8191 beside empty ones, a block table far
   wider than any length with its padding on poisoned pages,
   qwen2-moe-a2.7b's H=16, Hk=16, every slot at 8191, and one session at
   8191 alone or beside one at 33 (64 splits, past the merge pass's 32 at
   once), and the fleet's decode at minicpm-2b's H=Hk=36, hd=64 (its last
   step's lengths 2063, 315, 79, 27; 2047-2049 beside 160; 2063 alone);
   two launches must agree to the bit, also at 64 splits and at hd=64;
   timed with cold L2 at today's shape, qwen2-moe's, all-8191 and the
   fleet's minicpm-2b step, each beside
   its bytes bound, today's shape also with a clean cold L2 and with
   every length 0 (the floor); the split pass's
   shared memory and resident blocks, and both passes' ptxas registers and
   spills;
4. flash_attention — the kernel over ``FLASH_CASES`` (at hd=128: B=1,
   H=32, S=2048 causal, window 128, 17, a ragged S=2050, non-causal;
   ragged 97 with B=2; window 1; the serving layout's repeated k/v; q x 8;
   at minicpm-2b's hd=64, H=36: causal, ragged 2050, window 128, and q x 8
   in fp32 only; gate K-hy, hymba-1.5b's H=25, hd=64 under its 2048
   window at S=4096 and at a ragged 3000; gate K-vl, qwen2-vl-7b's H=28,
   hd=128 causal at S=2304 and a ragged 2050; gate K-wh, whisper-small's
   B=4, H=12, hd=64 causal at S=2048),
   fp32 and bf16, against ``flash_attention_plain``, each output equal to
   the bit with and without the lse output; timed at granite-8b's (H=32)
   and qwen2-moe-a2.7b's (H=16) causal prefill of 2048 tokens, at
   minicpm-2b's (H=36, hd=64) and at hymba-1.5b's windowed prefill of
   4096 tokens, at qwen2-vl-7b's prefill of 256 patches and 2048 text
   tokens (and the ragged 2050) and at whisper-small's decoder prompt of
   2048 tokens at B=4, with ``scaled_dot_product_attention`` (causal, or a
   boolean window mask) beside it as a yardstick only, and the kernel's
   ptxas registers, spills and shared memory;
   flash_backward — the backward kernel under gate T1 over
   ``FLASH_BWD_CASES`` (each case's reading over its bound), two launches
   bit-equal, the forward's lse within 1e-5 of the plain version's; timed
   with a cold L2 at minicpm-2b's (B=1, H=36, S=2048, hd=64),
   granite-8b's (H=32, hd=128) and qwen2-moe-a2.7b's (H=16, hd=128)
   causal shape, and at the training shapes of hymba-1.5b (H=25, hd=64,
   S=4096 under its 2048 window), qwen2-vl-7b (H=28, hd=128, S=2304) and
   whisper-small (B=2, H=12, hd=64, S=2048), beside its operations bound
   (the unmasked pairs only),
   the design's 3xTF32 floor, the plain version and the backward of
   ``scaled_dot_product_attention`` (a yardstick only), and its kernels'
   ptxas registers, spills and shared memory;
5. moe_gating — the logits-in gating kernel (off the main path since the
   router product was folded in) at T in {1, 8, 2048, 2050} and (E, K) in
   {(60, 4), (16, 4), (64, 8)}, plus duplicated logit columns (ties),
   against ``moe_gating_plain``: ids exactly, weights and probabilities
   within 1e-6; timed at T=8 (a decode step) and T=2048 (a prompt) for
   qwen2-moe-a2.7b's E=60, K=4;
   router_gating — the router product + gating kernel of the main path at
   T in {1, 8, 2048, 2050} and (D, E, K) in {(2048, 60, 4), (2048, 16, 4),
   (1024, 64, 8), (64, 60, 4)}, x ~ N(0, 1) and the router ~ N(0, (2 /
   sqrt(D))^2), one case at the init's 0.02 scale, constructed ties
   (twin router columns, a zero row of x) and cluster sizes 1 to 16,
   against ``router_gating_plain``: ids equal in every row whose plain
   K-th and (K+1)-th probabilities differ by more than TIE_GAP (in every
   row for the constructed ties; the others are counted), weights within
   1e-6 on rows whose ids agree, probabilities within 1e-6, two launches
   equal to the bit; timed with a cold L2, by a rewrite and by a read, at
   T=8 and T=2048 for qwen2-moe-a2.7b's D=2048, E=60, K=4 beside the old
   pair (cuBLAS product, then the logits-in kernel), an empty kernel of the
   same launch shape, the plain version and the four-call yardstick;
   router_gating_backward — the gating backward kernel of MoE training
   under gate R1 over ``GATING_BWD_CASES``, two launches bit-equal; timed
   with a cold L2 at one training micro-batch of qwen2-moe-a2.7b (T=2048,
   E=60, K=4) beside its bytes bound, an empty kernel of the same launch
   shape, the plain version, and both with the two products added;
6. small_parity — a reduced granite-8b and a reduced qwen2-moe-a2.7b with
   its 60 experts, top-4, each with fp32 (1e-4) and int8 (1e-2) pools,
   served on the card and on the CPU (plain versions) with the same
   weights: logits must agree and only the card's run launches the
   kernels; then hybrid_parity, gate Y1; then vlm_parity, gate V1; then
   audio_parity, gate A1; then train_parity, gate T2; then
   moe_train_parity, gate T2m; then the CPU runs of gates T2h, T2v, T2a
   and T2x start in a spawned worker process (``t2_cpu_runs``), which the
   serving phases below, host-bound on one core, leave the other cores
   to (it takes half of them);
7. serving  — granite-8b at full width and full depth in fp32 with
   seeded random weights: a ``BatchEngine`` admits 8
   sessions (two 2048-token prompts through the flash kernel, six short
   ones), decodes 32 greedy steps through the paged kernel and closes
   them; launch counts, page accounting, timings; then the recorded token
   feed is replayed through the per-slot path (logits within 1e-3 of the
   fused path) and the int8 pool (deviation reported), and a few steps
   are profiled;
8. serving_moe — granite-8b released, then qwen2-moe-a2.7b at full width
   and depth in fp32 (14.3 B parameters) served the same way, every
   layer's router product and gating through the router kernel: launch
   counts, page accounting, timings, peak memory, the per-slot replay
   within 1e-3, the int8 replay traced to where its routing first parts
   from the fp32 run's (reported, not bounded), and a profile of a few
   steps with the router product's and the gating's device time;
9. serving_xlstm — qwen2-moe-a2.7b released, then xlstm-1.3b at full width
   and depth in fp32 (5.64 B parameters) served per slot, every prefill's
   mLSTM layers through the mLSTM kernel, under gate G3; then the state
   handoff, layer by layer and end to end, with gate G1 on the kernel's
   real inputs in every mLSTM layer, and a profile of a few steps;
   serving_hybrid — xlstm-1.3b released, then hymba-1.5b at full width
   and depth in fp32 (1,644,856,000 parameters; window 2048 on every
   layer) served per slot under gate Y2, ``launch.serve.main`` once on
   the card, gate Y3's handoff, and a profile of a few steps;
   serving_vlm — hymba-1.5b released, then qwen2-vl-7b at full width and
   depth in fp32 (7,615,487,488 parameters in the tree) through
   ``GenerationEngine`` with 256 stubbed patch embeddings and through
   ``BatchEngine`` per slot, under gate V2, gate V3's handoff, a profile
   of 2 steps of each engine, and ``launch.serve.main`` once;
   serving_audio — qwen2-vl-7b released, then whisper-small at full width
   and depth in fp32 (335,106,048 parameters, enc_seq 1500) through
   ``GenerationEngine``, under gate A2, gate A3's handoff, a profile of 2
   decode steps, and ``launch.serve.main`` once; then
   hybrid_train_parity, vlm_train_parity, audio_train_parity and
   ssm_train_parity: the card runs of gates T2h, T2v, T2a and T2x, held
   to the worker's CPU runs;
10. training — whisper-small released, then minicpm-2b at full width and
   depth in fp32 (2.72 B parameters, AdamW) trained 4 steps at B=1,
   S=2048 through ``repro_torch.launch.train.main``, every layer's
   attention through the flash forward and backward kernels, under gate
   T3; its peak memory, and a step's forward, backward and optimizer
   ms; then moe_training — minicpm-2b released, qwen2-moe-a2.7b at full
   width cut to 4 layers, fp32, trained 4 steps at B=1, S=2048 through
   the port's ``Trainer`` under gate T3m: every layer's router gating
   through the router kernel forward and the gating backward kernel
   backward; its dropped share per layer, peak memory, a step's forward,
   backward and optimizer ms and tokens/s, and whether two gradient
   passes from one state agree to the bit; then hybrid_training,
   vlm_training and audio_training, each model released before the
   next: hymba-1.5b at full width and depth (1,644,856,000 parameters)
   trained 4 steps at B=1, S=4096 through ``launch.train.main``, its Mamba
   chunks recomputed in the backward (gate T3h); qwen2-vl-7b at full width
   cut to 4 layers (2,022,211,072 parameters), B=1, 256 patch embeddings
   + 2048 text tokens (gate T3v), and whisper-small at full width and
   depth (335,106,048 parameters), B=2, frames of (2, 1500, 768), S=2048
   (gate T3a), each 4 steps through the port's ``Trainer``; then
   ssm_training, xlstm-1.3b at full width cut to 8 layers (gate T3x), 4
   steps at B=1, S=2048 through ``launch.train.main``: launches, peak
   memory beside its prediction, a step's forward, backward and
   optimizer ms;
11. checkpoint — gate C1 on two small trees held on the card; then,
   everything before released, minicpm-2b at full width cut to
   ``CKPT_LAYERS`` = 6 of its 40 layers (``cut_depth``: the registry's
   config, so the launchers build it too; the checkpoint, mesh and fleet
   phases' seconds scale with the tree's bytes) trained for 2
   steps, saved with ``save_local`` into a temporary directory, loaded
   back onto the card and served, under gates C2-C5; the file's bytes,
   the save split into the encode, the copy from the card and the write,
   the load into the read, the decode and the copy to the card, GB/s of
   each, the parts-root-CID seconds, peak host RSS per stage, peak card
   memory, the root CID and the card's name and power limit;
12. mesh — the port's Lattica mesh (``core``, ``checkpoint.lattica_ckpt``)
   on the card's trees, under gates M1-M3: a fleet of four peers and the
   reference's two bootstrap/relay servers, the publisher behind a
   port-restricted cone NAT, the fetcher behind a symmetric NAT with
   random port allocation; gate C1's tree published and fetched sanitized,
   twice; then the checkpoint phase's trained minicpm-2b published from
   the card and fetched into a fresh init on it, and both trees served.
   The line carries the card's name and power limit, each stage's wall
   seconds and peak host RSS (``params_to_parts``, the DAG build, publish
   and provide, the fetch, reassembly, the copy to the card), the fetch's
   simulated seconds, the bytes moved, the connection path and the
   smoke's seconds so far;
13. fleet — the trained tree released, the port's serving fleet over its
   mesh on the tree gate M2 fetched onto the card, under gates F1-F3:
   ``serve_fleet`` of the cut minicpm-2b as 2 pipeline shards (layers
   0-2 and 3-5) x 2 replicas, 4 slots each, on four of six peers behind NATs,
   all four engines on the card and sharing the tree's storage, each
   shard's parameters published as its own checkpoint DAG; a
   ``ShardClient`` on another peer generates 16 greedy tokens for each of
   the prompts of C4 at once (F1), and again while the first shard-1
   replica to hold a slot is stopped (F2).  The line carries each
   generation's comparison with M3's run (rows compared, rows equal to the
   bit, the largest relative difference), the client's stats, the
   simulated seconds of the ``open`` and ``step`` RPCs (median and max),
   the wall seconds and peak host RSS of ``serve_fleet``, F1 and F2, the
   card's peak memory, the connection path of every client-shard and
   shard-shard pair, the launch counts beside their prediction, and the
   card's name and power limit.
14. collab — the fleet's tree released, the paper's collaborative RL
   pipeline on the port's trainers, under gates D1-D6: the outer math on
   card-held trees against golden constants (D2); two ``CollabWorker``s
   on NAT'd peers of a six-peer fleet training minicpm-2b at full width
   cut to 4 layers, 2 DiLoCo rounds of 2 inner steps at B=1, S=2048 each,
   top-k 0.05 with ``int8_block`` contributions (D1); the outer params
   published by the lead, fetched onto the card by a peer behind a
   symmetric NAT and served beside the lead's tree (D4); a
   ``LatticaSyncTrainer`` publishing every step and a ``ModelSubscriber``
   behind a symmetric NAT following it onto the card (D5); last, a
   reduced round on the card against the CPU and its TF32 control (D3),
   held after the line is printed.  The line carries the card's name and
   power limit, the outer digest, each worker's stats and wire ratio, the
   inner losses, D1's calls and seconds by function (the inner steps, the
   numpy outer math, the rest), D3's worst ratios to their bounds and the
   control's, the simulated seconds, connection path and leak audits,
   each stage's wall seconds and peak host RSS, the card's peak memory of
   D1, D4 and D5, and the launch counts.

The mlstm phase (after moe_gating) holds the mLSTM kernel to gate G1 at
xlstm-1.3b's widths and reports its two kernels' ptxas registers, spills
and shared memory, the mlstm_backward phase after it holds the kernel
under autograd to gate X1, and small_parity also serves a reduced xlstm-1.3b on
the card and on the CPU in float32 and float64 under gate G2.  The gates'
bounds are fixed in advance, each derived from a float64 reference:

* G1, kernel vs plain, on the card: with ``ref`` the plain version in
  float64 and ``p32`` the plain version in float32 on the same inputs,
  max|h - ref| <= 2 max|h_p32 - ref| + 1e-6 max|ref|; C and n within
  2e-5 of their largest reference entry; |m - m_ref| <= 2e-5 max(1,
  |m_ref|).
* G2, reduced xlstm-1.3b, card vs CPU, over every prefill's and step's
  logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).
* G3, full width on the card: finite logits; mlstm_scan launched 42 times
  per prefill of the served run; pages 0 after close; 807,666,432 state
  bytes per session; fed each layer the same input, prefill(2047) + one
  decode step against prefill(2048) leaves the mLSTM C and n and the
  sLSTM c, n and h within 1e-4 of their largest entry and every m within
  1e-4; and the end-to-end logits of the two routes differ by no more
  than one ulp of the input embeddings moves prefill(2048)'s.

The hybrid path's bounds (hymba-1.5b: attention under a 2048 window in a
ring-buffer cache beside a Mamba branch, served per slot), fixed before
this script's first run of them:

* K-hy, the flash kernel at hymba's shape: ``FLASH_CASES`` rows
  ``hymba_window2048`` (B=1, H=25, S=4096, window 2048, hd=64) and
  ``hymba_ragged3000`` (S=3000) under the flash bounds as written: 1e-4
  in fp32, 2e-2 in bf16, the output equal to the bit with and without
  the lse output.
* Y1, a reduced hymba-1.5b (``HYBRID_REDUCED``: L=4, d=256, H=4, Hk=1,
  hd=64, window 64, ssm_state 8, d_inner 512, vocab 512) served through
  ``BatchEngine`` on the card in fp32 and on the CPU in fp32 and float64
  on the same weights and the card's greedy feed, prompts 2048, 2100,
  12, 37, 64, 100, 200, 300, 32 decode steps; over every prefill's and
  step's logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).
  The card launches ``flash_attention`` exactly 4 x 2 times and nothing
  else; the CPU runs launch nothing.
* Y2, hymba-1.5b at full width and depth, fp32, 8 sessions, page 32,
  prompts 4096, 3000, 2048, 2047, 12, 37, 100, 256, 32 greedy steps per
  slot: finite logits; ``flash_attention`` launched exactly 32 x 3 times
  and nothing else; 0 pages after close; no session holds more than
  175,554,560 B of cache (32 x (2 x 2048 x 5 x 64 x 4 + 3200 x 16 x 4 +
  3 x 3200 x 4)), and every session whose length reached 2048 holds
  exactly that.  ``launch.serve.main(["--arch", "hymba-1.5b",
  "--prompt-len", "2100", "--gen", "8", "--batch", "1"])`` on the card
  ends with 8 tokens in the vocabulary.
* Y3, the handoff on Y2's model, in G3's form: fed each layer the same
  fp32 input, prefill(4095) + one decode step against prefill(4096)
  leaves the Mamba h and conv tail, and the ring's k and v slot for
  slot, within 1e-4 of their largest entry; |logits(4095 + 1) -
  logits(4096)| is no larger than what one ulp of the input embeddings
  moves prefill(4096)'s logits in the same run.
* Y4: every earlier gate passes as written, and the last line is the
  contract's.

The vlm and audio paths' bounds (qwen2-vl-7b: M-RoPE, 256 stubbed patch
embeddings, served through ``GenerationEngine`` and text per slot;
whisper-small: ``models/encdec.py``, served through ``GenerationEngine``),
fixed before this script's first run of them:

* K-vl, K-wh, the flash kernel at the new shapes: ``FLASH_CASES`` rows
  ``qwen2vl_2304`` (B=1, H=28, S=2304, hd=128, causal), ``qwen2vl_2050``
  (S=2050) and ``whisper_2048`` (B=4, H=12, S=2048, hd=64, causal) under
  the flash bounds as written: 1e-4 in fp32, 2e-2 in bf16, the output
  equal to the bit with and without the lse output.  Each row timed
  beside its bound (TF32 peak: 0.0769 ms, 0.0609 ms, 0.0521 ms) and SDPA.
* V1, a reduced qwen2-vl-7b (``VLM_REDUCED``: L=4, d=256, H=4, Hk=1,
  hd=64, sections (8, 12, 12), 16 patches, vocab 512) on one init, on
  the card in fp32 and on the CPU in fp32 and float64 fed the card's
  greedy tokens: ``GenerationEngine`` at B=2 over 16 patch embeddings and
  grid positions (patch i at (0, i // 4, i % 4), the text from max + 1
  on all three streams) before 2032 and 100 text tokens (totals 2048 and
  116), and ``BatchEngine`` per slot over the text prompts 2048, 2100,
  12, 37, 100, 300; 16 steps each.  Over every prefill's and step's
  logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).
  ``flash_attention`` launches exactly 4 x 3 times on the card (the
  prefills of >= 2048 tokens), nothing else; the CPU runs launch nothing.
* V2, qwen2-vl-7b at full width and depth, fp32: the tree holds
  ``param_count()`` + 2 L d = 7,615,487,488 parameters;
  ``GenerationEngine`` at B=2, 256 patches and grid positions + 2048 text
  tokens, 16 greedy steps; ``BatchEngine`` per slot, 4 sessions, page 32,
  prompts 2048, 2047, 100, 12, 16 greedy steps: finite logits of the
  vocab's width; ``flash_attention`` launched exactly 28 x 1 in each
  route, nothing else; 0 pages after close; each session's cache exactly
  114,688 B a token of its capacity.  ``launch.serve.main(["--arch",
  "qwen2-vl-7b", "--prompt-len", "2048", "--gen", "8", "--batch", "1"])``
  on the card, the model freed first, ends with 8 tokens in the vocab.
* V3, the handoff on V2's model in G3/Y3's form, 256 patches before the
  first slot prompt with broadcast positions (so that decode's
  cache-length position is the same position): fed each layer the same
  fp32 input, prefill(2303) + one decode step against prefill(2304)
  leaves k and v within 1e-4 of their largest entry; |logits(2303 + 1) -
  logits(2304)| is no larger than what one ulp of the input embeddings
  (the token embeddings and the patch embeddings) moves prefill(2304)'s
  logits in the same run.
* A1, a reduced whisper-small (L=2, enc_layers 2, enc_seq 64, d=256,
  H=Hk=4, hd=64, vocab 512) through ``GenerationEngine`` at B=2, prompts
  2048 and 37, 16 steps each, card fp32 against CPU fp32 and float64 on
  one init and the card's tokens: V1's bound; ``flash_attention``
  launches exactly 2 x 1 times on the card, nothing else, none on the
  CPU.
* A2, whisper-small at full width and depth, fp32 (enc_seq 1500):
  ``GenerationEngine`` at B=4, prompts 448 and 2048, 32 greedy steps
  each: finite logits; ``flash_attention`` launched exactly 12 times for
  the 2048 prompt and never for 448, nothing else; the encoder run once
  per generation; the cross K/V 110,592,000 B a session (12 x 2 x 1500 x
  12 x 64 x 4), ``torch.equal`` after the last step to what the prefill
  wrote.  ``launch.serve.main(["--arch", "whisper-small", "--prompt-len",
  "448", "--gen", "8", "--batch", "1"])`` ends with 8 tokens in the vocab.
* A3, the handoff on A2's model at 447 + 1 against 448 (B=1): fed each
  decoder layer the same fp32 input, k and v within 1e-4 of their
  largest entry; end to end, with a float64 copy of the weights on the
  card, the two routes in float64 within 1e-10 of the largest float64
  logit, and the handoff route's fp32 error at most twice the prefill's
  plus 1e-6 of that logit (G1's form).  V3's one-ulp ratio is printed,
  not held: on the CPU at full width it read 1.03-1.5 over 4 seeds (the
  token and frame embeddings moved), so that form fails a correct port.
  A wrong handoff fails that limit: the handoff route again with the
  cached self-attention k and v rounded to bf16 must read above it.
* V4/A4: every earlier gate passes as written, and the last line is the
  contract's.

The training path's bounds, fixed before this script's first run of them:

* T1, flash backward kernel vs plain, on the card, over
  ``FLASH_BWD_CASES`` (minicpm-2b's B=1, H=36, S=2048, hd=64 causal;
  granite-8b's H=32, hd=128; windows 128 and 1; ragged 2050; B=2 at 97;
  non-causal; Sq < Sk with a window; qwen2-moe-a2.7b's H=16, hd=128
  causal, added with MoE training), dO ~ N(0, 1) from a seeded
  generator, out and lse the plain forward in float64 rounded to fp32:
  with g64 the plain backward in float64 and g32 in fp32, for each of dq,
  dk, dv, max|g_kernel - g64| <= 2 max|g32 - g64| + 1e-6 max|g64|; the
  forward kernel's lse within 1e-5 of the plain version's; two launches
  equal to the bit.
* T2, a reduced minicpm-2b (L=2, d=256, H=4, hd=64, vocab 256), B=2,
  S=2048, card fp32 vs CPU fp32 and float64, micro-batches 1 and 2, three
  steps from the same state and batches: each step's loss and grad norm,
  and step 1's gradient leaves (each over its leaf's largest |cpu64|
  entry), max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).
* T3, minicpm-2b at full width and depth, fp32, B=1, S=2048, 4 steps
  through ``launch.train.main``: every loss and grad norm finite;
  ``flash_attention`` and ``flash_attention_bwd`` launched 40 x 4 times
  each, no other kernel; on one more step through ``make_train_step``'s
  gradient pass, every gradient leaf finite and not all zero, each
  layer-stacked leaf (wq, wk, wv among them) nonzero in every layer.

The MoE training path's bounds, fixed before this script's first run of
them:

* R1, gating backward kernel vs plain, on the card, over
  ``GATING_BWD_CASES`` (qwen2-moe-a2.7b's router, D=2048, E=60, K=4, at
  T=2048 and 4096 and a ragged 97; the reduced E=8, K=2 at D=256;
  constructed ties: twin router columns and a zero row of x), the gating
  the plain forward's, dweights and dprobs ~ N(0, 1) from a seeded
  generator: with g64 the plain backward in float64 and g32 in fp32, for
  each of dlogits, dx and drouter, max|g_kernel - g64| <= 2 max|g32 -
  g64| + 1e-6 max|g64|; two launches equal to the bit.
* T2m, T2's form on a reduced qwen2-moe-a2.7b (``T2M_REDUCED``: L=2,
  d=256, H=4, hd=64, vocab 256, E=8, K=2, capacity factor 1.0 so that
  tokens drop), B=2, S=2048, card fp32 vs CPU fp32 and float64,
  micro-batches 1 and 2, three steps from one state and one batch stream.
  Routing replay: the card run records every gating call's expert ids in
  call order; the CPU runs take them (``replaying_gating``: the plain
  probabilities, the recorded ids, weights the gathered probabilities
  over their clamped sum), each record's row count checked.  Each CPU
  call also computes its own top-k: every row whose expert set differs
  from the card's must be a tie, its cpu64 K-th and (K+1)-th
  probabilities within ``TIE_GAP``, and such rows at most 1% of all
  rows.  Step 1's gradient leaves, each over its leaf's largest |cpu64|
  entry, and each step's loss, aux and grad norm: max|card32 - cpu64| <=
  max(1e-4, 2 max|cpu32 - cpu64|).  Some (token, k) is dropped in at
  least one layer.  The card launches the flash forward and backward, the
  router kernel and the gating backward once per layer per micro-batch
  per pass (L x mb x (1 + steps) each), nothing else; the CPU runs
  launch nothing.
* T3m, qwen2-moe-a2.7b at full width cut to 4 layers (2,904,541,184
  parameters), fp32, B=1, S=2048, 4 steps through the port's ``Trainer``
  with ``launch.train``'s cosine schedule: every loss, aux and grad norm
  finite; ``flash_attention``, ``flash_attention_bwd``, ``moe_gating``
  and ``moe_gating_bwd`` launched 4 x 4 times each, no other kernel; on
  one more gradient pass, every gradient leaf finite, each layer-stacked
  leaf nonzero in every layer, and each (layer, expert) slice of w_gate,
  w_up and w_down nonzero exactly where that expert kept a token in that
  layer.  Every earlier gate passes as written, and the ``kernels`` line
  lists all six kernels (M4, F4 and D6 name the five of their time; the
  gating backward is the sixth).

The training bounds of the hybrid, vlm and audio archs, fixed before
this script's first run of them:

* T1, extended: ``FLASH_BWD_CASES`` rows ``hymba_window2048`` (B=1, H=25,
  S=4096, causal, window 2048, hd=64), ``qwen2vl_2304`` (B=1, H=28,
  S=2304, causal, hd=128) and ``whisper_B2`` (B=2, H=12, S=2048, causal,
  hd=64) under T1's bound as written.  Each is timed beside its bound
  (operations over the unmasked pairs: 6,292,480 of hymba's 8,390,656
  causal pairs a head) and the backward of SDPA (with the boolean window
  mask for hymba's).
* T2h, T2v, T2a, T2's form on the reduced configs that Y1, V1 and A1
  serve (``T2_ARCHS``: hymba L=4, d=256, window 64, ssm_state 8; qwen2-vl
  L=4, d=256, 16 patches on a 4 x 4 grid before 2032 text tokens;
  whisper L=2, enc_layers 2, enc_seq 64, d=256), B=2, S=2048, card fp32
  vs CPU fp32 and float64, micro-batches 1 and 2, three steps from one
  state and one batch stream: each step's loss and grad norm, and step
  1's gradient leaves (each over its leaf's largest |cpu64| entry),
  max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).  The card
  launches ``flash_attention`` and ``flash_attention_bwd`` L x mb x 3
  times each, nothing else; the CPU runs launch nothing.
* T3h, hymba-1.5b at full width and depth, fp32, B=1, S=4096 (the window
  masks a quarter of the causal pairs), 4 steps through
  ``launch.train.main``: every loss and grad norm finite;
  ``flash_attention`` and ``flash_attention_bwd`` launched exactly 32 x 4
  times each, nothing else; on one more gradient pass, every leaf finite
  and not all zero, and every layer-stacked leaf (``A_log``, ``dt_bias``,
  ``D_skip`` and ``conv_w`` of the Mamba branch among them) nonzero in
  every layer.  The peak is printed beside its prediction (66 GB).
* T3v, qwen2-vl-7b at full width cut to 4 layers (2,022,211,072
  parameters, recounted), fp32, B=1, 256 patches on a 16 x 16 grid + 2048
  text tokens (S=2304), 4 steps through ``Trainer``: T3h's checks, with
  flash and its backward 4 x 4 times each.
* T3a, whisper-small at full width and depth (335,106,048 parameters),
  fp32, B=2, frames ~ N(0, 1) of (2, 1500, 768), decoder S=2048, 4 steps
  through ``Trainer``: T3h's checks, with flash and its backward 12 x 4
  times each (the encoder and cross-attention launch none), and every
  encoder leaf nonzero in every layer.
* T4: every earlier gate passes as written; the serving gates Y1-Y4,
  V1-V4 and A1-A4 show that the Mamba loop without grad did not move.
  The checkpoint, mesh and fleet gates run at ``CKPT_LAYERS`` layers in
  their form and with their limits, every one exact; C1's and M1's
  golden trees are the reduced ones they were.

The xLSTM training bounds (``models.ssm.MLSTMScan``: the mLSTM kernel's
forward under autograd, its backward autograd of the plain scan's chunk
recomputed chunk by chunk, no kernel), fixed before this script's first
run of them:

* X1, ``MLSTMScan`` on the card (phase mlstm_backward), over
  ``MLSTM_BWD_CASES``: ``MLSTM_CASES`` rows S2048_cache, S300_cache,
  B2_S512_warm and jax_2x2x256x64, and S2048_empty (B=1, H=4, S=2048,
  hd=1024 from C = n = 0, m = -1e30, the training case); inputs from
  ``mlstm_inputs``, the cotangents of h, C_T, n_T and m_T ~ N(0, 1) from a
  seeded generator.  The forward under grad gives h, C_T, n_T and m_T
  ``torch.equal`` to ``ops.mlstm_scan`` under no_grad on the same inputs
  (``csrc/mlstm_scan.cu`` uses no atomics), launches ``mlstm_scan``
  exactly once, and the backward launches nothing.  With g64 autograd
  straight through ``mlstm_scan_plain`` in float64 on the card and g32
  the same in fp32, for each of dq, dk, dv, dlog_i, dlog_f, dC0, dn0 and
  dm0: max|g - g64| <= 2 max|g32 - g64| + 1e-6 max|g64| (T1's form); a
  gradient whose g64 is all zero reads all zero.  Printed, not held: the
  backward's ms at S2048_empty beside the forward kernel's ms and the
  fp32 plain autograd backward's ms, with a cold L2.
* T2x, T2's form on G2's reduced xlstm-1.3b at 8 layers
  (``get_config("xlstm-1.3b").reduced(n_layers=8)``: d=256, vocab 512,
  4 heads, mLSTM hd 128, layer 7 the sLSTM), B=2, S=2048 (8 chunks),
  micro-batches 1 and 2, three steps from one state and one batch stream
  (``t2_inputs``): each step's loss and grad norm, and step 1's gradient
  leaves (each over its leaf's largest |cpu64| entry), max|card32 -
  cpu64| <= max(1e-4, k max|cpu32 - cpu64|).  As first written k was 2,
  T2's own; the first chip run read 1.81 of that bound on an mLSTM
  layer's ``b_i``.  Before the second, a second witness, the port on the
  card with the mLSTM forward through the plain scan instead of the
  kernel, read the same at the gate's inputs (1.81 on leaves, 3.01 on a
  step-3 loss: 6.02 times cpu32's error) and up to 262 on seed 8's
  leaves, like the kernel's route; a card run with TF32 matmuls read
  3667 (``scripts/t2_witness.py``).  So k is 16, twice the largest sound
  reading rounded up to a power of two, in ``T2_ARCHS``.  A leaf whose
  cpu64 gradient is all zero (the branch its layer does not run) reads
  all zero on the card and in both CPU runs.  ``mlstm_scan`` launches
  exactly 7 x mb x 3 times on the card, nothing else; none on the CPU.
  The CPU runs go to the smoke's spawned worker, as T2h, T2v and T2a do.
* T3x, xlstm-1.3b at full width cut to 8 layers (``cut_depth``: 7 mLSTM
  layers and 1 sLSTM layer; 1,112,279,104 parameters, 17.8 GB at 16 B a
  parameter), fp32, B=1, S=2048, 4 steps through ``launch.train.main``
  at lr 3e-4 (at the launcher's 3e-3 its fp32 run leaves the finite
  numbers, ``T3_ARCHS``): every loss and grad norm finite; ``mlstm_scan`` launched exactly 7 x 4
  times over the steps, nothing else; on one more gradient pass every
  leaf finite, in each layer every leaf of the branch it runs (``mlstm``
  in layers 0-6, ``slstm`` in layer 7) and ``ln1`` not all zero, every
  leaf of the branch it does not run exactly zero, and ``embed``,
  ``lm_head`` and ``final_norm`` not all zero.  Printed: one more step
  timed in its forward, backward and optimizer parts, and the peak beside
  its prediction (23 GB).
* X-T5: every earlier gate passes as written (T1-T4, G1-G3, Y1-Y4,
  V1-V4, A1-A4, R1, T2m, T3m, C1-C5, M1-M4, F1-F4 and D1-D6), with its
  launch counts unchanged, and the last line is the contract's.

The checkpoint format's bounds, fixed before this script's first run of
them (every one exact):

* C1, golden CIDs of card-held trees: a reduced minicpm-2b
  (``T2_REDUCED``: L=2, d=256, vocab 256) filled by
  ``golden_numpy_tree`` in fp32, and again cast to bf16 (round to nearest
  even), each crossed to the card with ``params_from_numpy``: the root
  CID of ``build_tree_dag(params_to_parts(tree))``, the sha256 of
  ``params_to_bytes(tree)`` and (fp32) of ``params_to_bytes(tree,
  quant="int8_block")`` equal ``CKPT_GOLDEN``, which the JAX package
  computed on the CPU.
* C2, full width (cut to ``CKPT_LAYERS`` layers since the hybrid, vlm
  and audio archs train in the smoke): minicpm-2b, fp32, B=1, S=2048, 2
  steps through the
  ``Trainer`` that ``launch.train.run`` builds; saved by the
  ``save_local`` call ``--save`` makes; the optimizer moments freed;
  ``load_local(path, like=<a fresh init on the card>)``: every leaf on
  the card, of the trained leaf's dtype and shape, ``torch.equal`` to
  it; at least one leaf differs from the fresh init.
* C3: ``params_to_bytes(loaded)`` hashes to the file's sha256, and the
  loaded tree's parts root CID equals the trained tree's.
* C4: the trained tree and then the loaded tree served through the
  fused ``BatchEngine`` (4 sessions, prompts 2048, 300, 64 and 12
  tokens, 16 greedy steps, page 32): the same greedy tokens, every
  logits row equal to the bit, the same launch counts.
* C5: ``launch.serve.main(["--arch", "minicpm-2b", "--load", path,
  "--batch", "2", "--prompt-len", "64", "--gen", "8"])`` on the card
  gives the tokens of a ``GenerationEngine`` over the trained tree on
  the batch ``launch.serve`` draws from its seed, and those differ from
  the tokens of the untrained start (``launch.serve``'s own init) on
  that batch, so the gate tells the checkpoint from a fresh init.

The temporary files are deleted when the phase ends, whatever happens.

The mesh's bounds, fixed before this script's first run of them (every
one exact):

* M1, reduced size, golden and sanitized: gate C1's fp32 tree on the
  card; ``mesh_scenario`` under ``Sim(seed=MESH_SEED, sanitize=True)``:
  ``publish_checkpoint`` on the publisher, ``fetch_latest`` on the fetcher
  with ``like`` a fresh init on the card.  The root CID, the trace digest,
  the number of events traced and the fetch's simulated seconds equal
  ``MESH_GOLDEN`` (which ``tests/test_torch_mesh.py`` re-derives through
  the JAX package and the port on the CPU); every fetched leaf is on the
  card and ``torch.equal`` to the published one; the sanitizer reports no
  double-settle and no orphan, and the leak audit after both nodes finish
  (their lineage pins released, the fetcher's connection to the publisher
  closed) is empty.  Run twice: the same report both times.
* M2, full width: the same fleet, unsanitized; the trained minicpm-2b
  published from the card and fetched with ``fetch_checkpoint(...,
  like=<a fresh init on the card>)``: every leaf on the card, of the
  trained leaf's dtype and shape, ``torch.equal`` to it; the root
  manifest's per-leaf entry CIDs those of ``build_tree_dag(params_to_parts(
  trained))`` (the checkpoint phase's C3 DAG); the leak audit after both
  nodes finish empty.
* M3: the trained and then the fetched tree served as C4 serves (prompts
  2048, 300, 64, 12; 16 greedy steps; page 32): every logits row equal to
  the bit, the same tokens, the same paged and flash launch counts.
* M4: every earlier gate passes as written, the ``kernels`` line lists all
  five kernels, and the last line is the contract's.

The serving fleet's bounds, fixed before this script's first run of them.
The reference is M3's run of the fetched tree: the fused ``BatchEngine``
alone over the same prompts (2048, 300, 64, 12 tokens), recorded per
session and step; the fleet's rows are the logits its client samples each
token from (``ShardClient._sample``), 16 per session:

* F1, full width: every session completes; its tokens equal the
  reference's greedy tokens, a first difference allowed only where the
  reference's top two logits lie within ``TIE_GAP`` (1e-5), that session's
  comparison stopping there; every compared logits row lies within
  1e-4 * max(1, max|reference row|) of the reference's row.  The rows
  equal to the bit are counted.
* F2, a torch-shard kill: the same prompts again on the same fleet; at
  the first poll (every 10 simulated ms) at which a live shard-1 replica
  holds a slot, ``stop()`` is called on it.  No session fails,
  ``sessions_migrated`` grows by at least 1, and tokens and logits are
  held to the reference under F1's bounds.  No work reaches the stopped
  server after ``stop()``: its engine's ``admitted``, ``prefills``,
  ``steps`` and ``step_sessions`` stay as they were (the client's close
  RPCs for the migrated sessions still reach it, as in the reference).
* F3, kernels and memory: over the phase, from ``serve_fleet`` to the end
  of F2, only ``paged_decode_attention`` and ``flash_attention`` launch,
  as many times as the shards' own work predicts: the sum over the four
  servers of (layers of the shard) x (fused steps that served at least
  one session) for paged decode, and (layers of the shard) x (prefills of
  at least ``FLASH_MIN_SEQ`` = 2048 tokens) for flash, each server's
  record agreeing with its engine's ``prefills`` and ``steps``; after each
  generation, once the client has closed its sessions (30 simulated
  seconds on), every live shard's engine holds 0 slots and 0 pages.
* F4: every earlier gate passes as written, the ``kernels`` line lists
  all five kernels, and the last line is the contract's.

The collaborative-training bounds, fixed before this script's first run
of them.  The fleet is the port's ``make_fleet(6, nat_kinds=
collab_nat_kinds(...))`` under ``Sim(seed=COLLAB_SEED)`` from
``fresh_counters``; ``CollabConfig(inner_steps=2, settle=0.5,
topk_frac=0.05, quant="int8_block", keep_rounds=1)``; lr 1e-3, cosine,
no warmup:

* D1, rounds: both workers' ``run(2)`` return 2 and reach outer round 2;
  no round aborted or degraded; one outer digest across the workers;
  wire bytes / dense bytes <= 0.10 for each; no overdue pin after the
  fleet quiesces; every inner loss and grad norm finite.
* D2, the outer math, exact: gate C1's fp32 tree and the same tree drawn
  from seed + 1, on the card: ``tree_to_flat`` of both, the
  pseudo-gradient, ``compress_pseudograd(frac=0.05, quant="int8_block")``
  and one Nesterov outer step from zero momentum (``collab_golden``); the
  sha256 over the parts, the digests of ``sent`` and of the outer params
  and the stats equal ``COLLAB_GOLDEN``, which the JAX package computed
  on the CPU.
* D3, card against CPU: a reduced minicpm-2b (``T2_REDUCED``), two
  workers, one round of 2 steps at S=2048 from one init and one batch
  stream, on the card in fp32 and on the CPU in fp32 and float64, in
  T2's form per leaf over its largest |cpu64| entry, max|card32 - cpu64|
  <= max(1e-4, 2 max|cpu32 - cpu64|): D3a, each step's gradient before
  clipping (each run on its own trajectory); D3b, each worker's round-0
  pseudo-gradient against the port's clip and AdamW replayed on the CPU
  in float64 on the card's own gradients (the float32 replay standing for
  cpu32).  The pseudo-gradients of the three runs are not compared with
  each other: AdamW divides each element by its own magnitude plus 1e-8,
  which turns the rounding of an element far below its leaf's largest
  into a large share of the lr (the first form of D3, held before this
  one, read 8.46 of its bound for that reason).  The card run launches
  the flash forward and backward once per layer per step, the CPU runs
  never; a control round on the card with TF32 matmuls allowed must read
  over D3a's bound.
* D4, publish, fetch, serve: the lead publishes ``outer_params()`` as
  step 2; an edge behind a symmetric NAT runs ``fetch_latest_from`` into
  a fresh init on the card: its step is the registry's latest, every leaf
  is on the card and ``torch.equal`` to the outer params; both trees
  served as C4 serves but with prompts of 64 and 12 tokens and 8 greedy
  steps give the same tokens, bit-equal logits and equal launch counts.
  After both nodes finish (pins released, the edge hung up), no leak gauge
  stands above its level before the publish (D1's half-open streams, a
  hazard of the reference, may close below it).
* D5: a ``LatticaSyncTrainer`` on a full-cone peer runs
  ``run_mesh(2)`` with ``publish_every=1``; a ``ModelSubscriber`` behind
  a symmetric NAT, ``like`` a fresh init on the card, follows until step
  2: its ``current_step`` is 2, every leaf on the card and ``torch.equal``
  to the trainer's, and both registries' latest agree.
* D6, kernels and memory: in D1 and D5 only the flash forward and
  backward launch, each 4 x (inner steps taken) times (4 x 8, 4 x 2); in
  D4 only paged decode, 4 x 8 times.  The card's and the host's peaks are
  printed.  Every earlier gate passes as written, the ``kernels`` line
  lists all five kernels, and the last line is the contract's.

Then a ``done`` line with the run's seconds, a ``{"kernels": [...]}``
line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Without a card, or without ``src/repro_torch`` beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth,
#: TF32 and bf16 tensor-core rates, and fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
FP32_SIMT_FLOPS = 67e12

PAGED_LENGTHS = [0, 31, 32, 33, 100, 2047, 2048, 2069]
SERVE_PROMPTS = [2048, 2048, 12, 37, 64, 100, 200, 256]
SERVE_STEPS = 32
#: xlstm-1.3b: one 2048-token prompt (8 chunks of 256 in the JAX model),
#: one ragged (one chunk of 300) and six short ones
XLSTM_PROMPTS = [2048, 300, 12, 37, 64, 100, 200, 256]
#: the reduced xlstm's prompts: the ragged W = S form and two full chunks
XLSTM_SMALL_PROMPTS = [12, 37, 64, 100, 200, 256, 300, 512]
XLSTM_SMALL_STEPS = 16
#: xlstm-1.3b's recurrent state of one session: per layer C (4, 1024,
#: 1024), n (4, 1024), m (4) and the sLSTM's four (4, 512), in fp32
XLSTM_STATE_BYTES = 807_666_432
#: hymba-1.5b (Y2): two prompts past the 2048 window (4096 in 32 Mamba
#: chunks, a ragged 3000 in one), one that fills it, one a token short
#: that crosses it in decode, four short ones
HYBRID_PROMPTS = [4096, 3000, 2048, 2047, 12, 37, 100, 256]
#: the reduced hymba of gate Y1 and its prompts: two through the flash
#: branch, the ring filled exactly (64), three through the masked branch
#: over the ring (the reference's hazard), two that wrap it in decode
HYBRID_REDUCED = {"n_layers": 4}
HYBRID_SMALL_PROMPTS = [2048, 2100, 12, 37, 64, 100, 200, 300]
HYBRID_SMALL_STEPS = 32
#: hymba-1.5b's cache of one session at the window: per layer k and v
#: (2048, 5, 64), the Mamba h (3200, 16) and conv (3, 3200), in fp32
HYBRID_STATE_BYTES = 175_554_560
#: gate V1: a reduced qwen2-vl-7b (d=256, H=4, Hk=1, hd=64, sections (8,
#: 12, 12), 16 patches, vocab 512) at L=4; ``GenerationEngine`` over 16
#: patches and these text lengths (totals 2048 and 116), ``BatchEngine``
#: per slot over the text prompts
VLM_REDUCED = {"n_layers": 4}
VLM_SMALL_TEXT = [2032, 100]
VLM_SMALL_PROMPTS = [2048, 2100, 12, 37, 100, 300]
VLM_SMALL_STEPS = 16
#: gate V2: qwen2-vl-7b at full width, 256 patches + 2048 text tokens
#: through ``GenerationEngine`` at B=2, these text prompts per slot
VLM_TEXT = 2048
VLM_PROMPTS = [2048, 2047, 100, 12]
VLM_STEPS = 16
#: qwen2-vl-7b's k/v per token of a session: 28 x 2 x 4 x 128 x 4 B
VLM_KV_BYTES_PER_TOKEN = 114_688
#: gate A1: a reduced whisper-small (L=2, enc_layers 2, enc_seq 64,
#: d=256, H=Hk=4, hd=64, vocab 512), B=2 at each prompt length
AUDIO_SMALL_PROMPTS = [2048, 37]
AUDIO_SMALL_STEPS = 16
#: gate A2: whisper-small at full width, B=4 at each prompt length: 448
#: (Whisper's own decoder limit) and 2048 (the flash branch)
AUDIO_PROMPTS = [448, 2048]
AUDIO_BATCH = 4
AUDIO_STEPS = 32
#: whisper-small's cross K/V per session: 12 x 2 x 1500 x 12 x 64 x 4 B
AUDIO_CROSS_BYTES = 110_592_000
GATING_T = (1, 8, 2048, 2050)
GATING_EK = ((60, 4), (16, 4), (64, 8))
#: two runs of one feed may route a token differently only where its K-th
#: and (K+1)-th expert probabilities were this close in both (a rounding
#: tie; both runs' products differ in the last bits)
TIE_GAP = 1e-5


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, flush=None,
            flush_by_read: bool = False) -> float:
    """Median CUDA-event time of ``fn`` in ms; with ``flush``, a buffer
    larger than L2 is rewritten before each launch (cold caches, L2 full of
    dirty lines that ``fn``'s reads write back), or with ``flush_by_read``
    read instead (cold and clean)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.sum() if flush_by_read else flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# --------------------------------------------------------------- kernels

def paged_inputs(torch, lengths, H, Hk, page=32, hd=128, width=None,
                 spare=16, seed=0):
    """A pool on the card with ragged lengths: every row a slot does not
    own below its length is poisoned (large and finite), and ``spare``
    pages no slot owns.  The block table is ``width`` pages wide (default:
    the widest slot's), and its padding is page 0, or with ``width`` the
    poisoned spare pages.  Returns the fp32 and int8 argument tuples."""
    import numpy as np

    from repro_torch.serving.batch import _quant_page_int8

    dev = torch.device("cuda")
    M = len(lengths)
    # the engine allocates the current token's page before the step
    owned = [-(-(L + 1) // page) for L in lengths]
    NP = width or max(owned)
    P = sum(owned) + spare
    rng = np.random.default_rng(seed)
    perm = rng.permutation(P)
    bt = np.zeros((M, NP), np.int32)
    live = np.zeros((P, page), bool)
    at = 0
    for m, (L, n) in enumerate(zip(lengths, owned)):
        bt[m, :n] = perm[at:at + n]
        if width:
            bt[m, n:] = perm[sum(owned):][np.arange(NP - n) % spare]
        at += n
        for t in range(L):
            live[bt[m, t // page], t % page] = True
    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn((P, page, Hk, hd), generator=g, device=dev)
    vp = torch.randn((P, page, Hk, hd), generator=g, device=dev)
    stale = torch.from_numpy(~live).to(dev)
    kp[stale] = 1e4                               # poison: large and finite
    vp[stale] = -1e4
    q = torch.randn((M, H, hd), generator=g, device=dev)
    kn = torch.randn((M, Hk, hd), generator=g, device=dev)
    vn = torch.randn((M, Hk, hd), generator=g, device=dev)
    bt_t = torch.from_numpy(bt).to(dev)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kq, ks = _quant_page_int8(kp)
    vq, vs = _quant_page_int8(vp)
    return ((q, kp, vp, bt_t, len_t, kn, vn),
            (q, kq, vq, bt_t, len_t, kn, vn, ks, vs))


def paged_bound_ms(lengths, H, Hk, hd=128, page=32, itemsize=4,
                   scales=False) -> float:
    """Least time of one call: each live K/V row, each live page's scales
    and block-table entry, q, out, k/v_new and lengths moved once."""
    M = len(lengths)
    pages_read = sum(-(-L // page) for L in lengths)
    fixed = (2 * M * H * hd + 2 * M * Hk * hd) * 4 + M * 4 + pages_read * 4
    kv = sum(lengths) * Hk * hd * 2 * itemsize
    sc = pages_read * Hk * 4 * 2 if scales else 0
    return (kv + sc + fixed) / HBM_BYTES_PER_S * 1e3


#: the split pass's edges (name: H, Hk, hd, lengths, table width), held
#: against the plain version like today's shape: lengths either side of the
#: 4-page (128-row) splits granite-8b's decode plans, one slot at 8191 beside
#: empty ones, a table far wider than any length whose padding points at
#: poisoned pages, qwen2-moe-a2.7b's heads, every slot at 8191, one long
#: session decoding alone or beside a short one (64 splits, past the 32 the
#: merge pass reads at once), and the fleet's decode at minicpm-2b's widths
#: (H=Hk=36, hd=64: the hd64/rep1 instantiations): its last step's lengths
#: (prompts of 2048, 300, 64 and 12 tokens, 16 generated), the page edges
#: around 2048, and the long session alone
PAGED_CASES = {
    "split_edges": (32, 8, 128, [127, 128, 129, 255, 256, 257, 0, 1], None),
    "long_8191": (32, 8, 128, [8191, 0, 0, 0, 0, 0, 0, 0], None),
    "wide_table": (32, 8, 128, [0, 5, 40, 100, 31, 64, 1, 33], 256),
    "qwen_heads": (16, 16, 128, PAGED_LENGTHS, None),
    "all_8191": (32, 8, 128, [8191] * 8, None),
    "alone_8191": (32, 8, 128, [8191], None),
    "pair_8191_33": (32, 8, 128, [8191, 33], None),
    "minicpm_fleet": (36, 36, 64, [2063, 315, 79, 27], None),
    "minicpm_page_edges": (36, 36, 64, [2047, 2048, 2049, 160], None),
    "minicpm_alone": (36, 36, 64, [2063], None),
}
#: cases timed beside today's shape, each in fp32 and int8
PAGED_TIMED = ("qwen_heads", "all_8191", "minicpm_fleet")
#: cases whose two launches must also agree to the bit
PAGED_REPEAT = ("alone_8191", "minicpm_alone")


def paged_check(torch, pa, name, fp32, int8) -> dict:
    """max |kernel - plain| in fp32 and int8; finite outputs."""
    err = {}
    for kind, args in (("fp32", fp32), ("int8", int8)):
        got = pa.paged_attention_cuda(*args)
        want = pa.paged_attention_plain(*args)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()),
                f"paged {name} {kind}: non-finite")
        err[kind] = (got - want).abs().max().item()
    return err


def paged_repeat(torch, pa, fp32, int8) -> dict:
    """No atomics: a second launch on the same inputs is equal to the bit,
    in fp32 and int8."""
    repeat = {}
    for kind, args in (("fp32", fp32), ("int8", int8)):
        a = pa.paged_attention_cuda(*args)
        b = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        repeat[kind] = bool(torch.equal(a, b))
    return repeat


def paged_ptxas(log: str) -> dict:
    """ptxas's report of each paged kernel instantiation."""
    def key_of(name):
        m = re.search(r"paged_(split|merge)_kernelI(?:([fa])Li(\d+)ELi(\d+)E"
                      r"|Li(\d+)ELi(\d+)E)", name)
        if m is None:
            return None
        if m.group(1) == "split":
            kind = "fp32" if m.group(2) == "f" else "int8"
            return f"split_{kind}_hd{m.group(3)}_rep{m.group(4)}"
        return f"merge_hd{m.group(5)}_rep{m.group(6)}"
    return ptxas_report(log, key_of)


def paged_phase(torch, flush, build_log: str = ""):
    from repro_torch.kernels import paged_attention as pa

    M, H, Hk, hd, page = 8, 32, 8, 128, 32
    lengths = PAGED_LENGTHS
    fp32, int8 = paged_inputs(torch, lengths, H, Hk)
    err = paged_check(torch, pa, "today", fp32, int8)
    # tolerance: fp32 sums over up to ~8k keys in another order
    require(max(err.values()) <= 1e-4, f"paged kernel disagrees: {err}")
    cases = {}
    for name, (h, hk, chd, lens, width) in PAGED_CASES.items():
        c32, c8 = paged_inputs(torch, lens, h, hk, hd=chd, width=width)
        e = paged_check(torch, pa, name, c32, c8)
        require(max(e.values()) <= 1e-4, f"paged {name} disagrees: {e}")
        NP = c32[3].shape[1]
        pps = pa.split_pages(NP, page, len(lens), hk)
        cases[name] = {"H": h, "Hk": hk, "hd": chd, "lengths": lens,
                       "table_width": NP,
                       "pages_per_split": pps, "splits": -(-NP // pps),
                       "max_abs_err": e}
        if name in PAGED_REPEAT:
            cases[name]["bit_repeat"] = paged_repeat(torch, pa, c32, c8)
            require(all(cases[name]["bit_repeat"].values()),
                    f"paged {name} not bit-repeatable")
        if name in PAGED_TIMED:
            cases[name].update(
                kernel_ms=time_ms(torch, lambda: pa.paged_attention_cuda(*c32),
                                  flush=flush),
                kernel_int8_ms=time_ms(
                    torch, lambda: pa.paged_attention_cuda(*c8), flush=flush),
                bound_ms=paged_bound_ms(lens, h, hk, hd=chd),
                bound_int8_ms=paged_bound_ms(lens, h, hk, hd=chd, itemsize=1,
                                             scales=True))
        del c32, c8
    repeat = paged_repeat(torch, pa, fp32, int8)
    require(all(repeat.values()), f"paged kernel not bit-repeatable: {repeat}")

    empty = (*fp32[:4], torch.zeros_like(fp32[4]), *fp32[5:])
    res = {
        "max_abs_err": err,
        "kernel_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*fp32),
                             flush=flush),
        "kernel_int8_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*int8),
                                  flush=flush),
        "plain_ms": time_ms(torch, lambda: pa.paged_attention_plain(*fp32),
                            iters=5, flush=flush),
        # the same launch with L2 evicted by a read: no dirty lines to write
        # back, as in a decode step, where L2 holds mostly weights
        "kernel_clean_l2_ms": time_ms(
            torch, lambda: pa.paged_attention_cuda(*fp32), flush=flush,
            flush_by_read=True),
        # both passes over the same table with every length 0: launches,
        # empty splits and the merge, with no cached row
        "floor_ms": time_ms(torch, lambda: pa.paged_attention_cuda(*empty),
                            flush=flush),
        "bound_ms": paged_bound_ms(lengths, H, Hk),
        "bound_int8_ms": paged_bound_ms(lengths, H, Hk, itemsize=1,
                                        scales=True),
        # no single PyTorch call computes attention through a block table
        "library_ms": None,
    }
    emit({"phase": "paged_decode_attention", "M": M, "H": H, "Hk": Hk,
          "hd": hd, "page": page, "lengths": lengths,
          "pages_per_split": pa.split_pages(fp32[3].shape[1], page, M, Hk),
          **res, "bit_repeat": repeat, "cases": cases,
          "split_config": {f"{k}_hd{d}_rep{r}": pa.split_config(k == "int8",
                                                                 d, r)
                           for k in ("fp32", "int8")
                           for d, r in ((128, 4), (128, 1), (64, 1))},
          "ptxas": paged_ptxas(build_log)})
    return res


def ptxas_report(log: str, key_of) -> dict:
    """Registers, static shared memory, spill bytes and stack of each entry
    function that ``key_of`` names (mangled name -> key, or None to skip),
    from an ``-Xptxas -v`` build log (empty when nothing was built)."""
    res, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            key = key_of(m.group(1))
            if key is not None:
                res[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            res[key].update(stack_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            res[key].update(registers=int(m.group(1)), static_smem_bytes=int(
                smem.group(1)) if smem else 0)
            key = None
    return res


def flash_ptxas(log: str) -> dict:
    """ptxas's report of each flash kernel instantiation."""
    def key_of(name):
        if "flash_fwd_kernel" not in name:
            return None
        hd = re.search(r"Li(\d+)EE", name).group(1)
        return ("bf16" if "bfloat16" in name else "fp32") + f"_hd{hd}"
    return ptxas_report(log, key_of)


def mlstm_ptxas(log: str) -> dict:
    """ptxas's report of the mLSTM scan's two kernels."""
    return ptxas_report(log, lambda name: "prep" if "mlstm_prep_kernel" in name
                        else "walk" if "mlstm_walk_kernel" in name else None)


#: (name, B, H, Sq, Sk, causal, window, form, hd): the served prefill,
#: ragged tiles, narrow windows, a batch, the serving layout ("gqa": k/v of
#: (B, S, H/4, hd) repeat_interleaved, as models/common.py builds them),
#: large scores ("large": q x 8, where the running-max rescale matters),
#: and minicpm-2b's trained attention (H=36, hd=64)
FLASH_CASES = [("causal", 1, 32, 2048, 2048, True, 0, "bshd", 128),
               ("window128", 1, 32, 2048, 2048, True, 128, "bshd", 128),
               ("ragged", 1, 32, 2050, 2050, True, 0, "bshd", 128),
               ("noncausal", 1, 32, 128, 2048, False, 0, "bshd", 128),
               ("ragged97_B2", 2, 8, 97, 97, True, 0, "bshd", 128),
               ("window17", 1, 32, 2048, 2048, True, 17, "bshd", 128),
               ("window1", 1, 8, 300, 300, True, 1, "bshd", 128),
               ("gqa", 1, 32, 2048, 2048, True, 0, "gqa", 128),
               ("large", 1, 32, 2048, 2048, True, 0, "large", 128),
               ("minicpm", 1, 36, 2048, 2048, True, 0, "bshd", 64),
               ("minicpm_ragged", 1, 36, 2050, 2050, True, 0, "bshd", 64),
               ("minicpm_window128", 1, 36, 2048, 2048, True, 128, "bshd", 64),
               ("minicpm_large", 1, 36, 2048, 2048, True, 0, "large", 64),
               ("hymba_window2048", 1, 25, 4096, 4096, True, 2048, "bshd", 64),
               ("hymba_ragged3000", 1, 25, 3000, 3000, True, 2048, "bshd", 64),
               ("qwen2vl_2304", 1, 28, 2304, 2304, True, 0, "bshd", 128),
               ("qwen2vl_2050", 1, 28, 2050, 2050, True, 0, "bshd", 128),
               ("whisper_2048", 4, 12, 2048, 2048, True, 0, "bshd", 64)]
#: rows checked in fp32 only: q x 8 at hd=64 makes near one-hot rows whose
#: outputs reach 4-8 in magnitude, where one bf16 ulp is 0.03125, past the
#: 2e-2 bf16 bound (an H100 run read exactly that); the trained path is
#: fp32
FLASH_FP32_ONLY = ("minicpm_large",)


def flash_inputs(torch, B, H, Sq, Sk, hd, dtype, form, g):
    """q, k, v on the card in the main path's layout: (B, S, H, hd) viewed
    as (B, H, S, hd)."""
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device="cuda")
               .to(dtype).transpose(1, 2) for S in (Sq, Sk, Sk))
    if form == "gqa":
        k, v = (torch.repeat_interleave(t.transpose(1, 2)[:, :, ::4], 4, dim=2)
                .transpose(1, 2) for t in (k, v))
    elif form == "large":
        q = q * 8
    return q, k, v


def flash_phase(torch, flush, build_log: str):
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    hd = 128
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, H, Sq, Sk, causal, window, form, d in FLASH_CASES:
            if dtype != torch.float32 and name in FLASH_FP32_ONLY:
                continue
            q, k, v = flash_inputs(torch, B, H, Sq, Sk, d, dtype, form, g)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            with_lse, _ = fa.flash_attention_cuda(
                q, k, v, causal=causal, window=window, return_lse=True)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            key = f"{name}_{str(dtype).split('.')[1]}"
            require(bool(torch.isfinite(got.float()).all()), f"flash {key}")
            require(torch.equal(got, with_lse),
                    f"flash {key}: the lse output changed the output")
            errs[key] = (got.float() - want.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            require(errs[key] <= tol, f"flash {key}: err {errs[key]} > {tol}")

    def timed(B, H, S, dtype=torch.float32, hd=hd, window=0):
        """Kernel, plain and SDPA times at a causal prefill of S tokens
        (under a sliding ``window``: SDPA with the same boolean mask), and
        the bound: only the unmasked pairs' FLOP, each input read and the
        output written once."""
        q, k, v = flash_inputs(torch, B, H, S, S, hd, dtype, "bshd", g)
        pairs = (sum(min(i + 1, window) for i in range(S)) if window
                 else S * (S + 1) // 2)
        flops = 4 * B * H * hd * pairs
        nbytes = 4 * B * H * S * hd * q.element_size()
        peak = PEAK_FLOPS[str(dtype).split(".")[1]]
        res = {"kernel_ms": time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, window=window), flush=flush)}
        if dtype == torch.float32:
            res["plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_plain(q, k, v,
                                                        window=window),
                iters=5, flush=flush)
            if window:
                i = torch.arange(S, device="cuda")
                keep = (i[None, :] <= i[:, None]) & (
                    i[None, :] > i[:, None] - window)
                res["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=keep), flush=flush)
            else:
                res["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), flush=flush)
        res["bound_ms"] = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        res["bound_by"] = ("operations" if flops / peak
                           >= nbytes / HBM_BYTES_PER_S else "bytes")
        return res

    # the main path's case: granite-8b's causal fp32 prefill of 2048 tokens
    B, H, S = 1, 32, 2048
    res = {"max_abs_err": errs,
           "max_abs_err_fp32": max(v for k, v in errs.items()
                                   if k.endswith("float32")),
           **timed(B, H, S)}
    bf16 = timed(B, H, S, torch.bfloat16)
    res["kernel_bf16_ms"] = bf16["kernel_ms"]
    res["bound_bf16_ms"] = bf16["bound_ms"]
    # qwen2-moe-a2.7b's prefill: 16 heads; minicpm-2b's trained forward
    res["H16"] = timed(B, 16, S)
    res["H36_hd64"] = timed(B, 36, S, hd=64)
    # hymba-1.5b's prefill of 4096 tokens: H=25, hd=64, window 2048
    res["hymba_H25_hd64_S4096_window2048"] = timed(B, 25, 4096, hd=64,
                                                   window=2048)
    # qwen2-vl-7b's prefill of 256 patches + 2048 text tokens (and a
    # ragged 2050), whisper-small's decoder prompt of 2048 tokens at B=4
    res["qwen2vl_H28_S2304"] = timed(1, 28, 2304)
    res["qwen2vl_H28_S2050"] = timed(1, 28, 2050)
    res["whisper_B4_H12_hd64_S2048"] = timed(4, 12, 2048, hd=64)
    lib = build.load("flash_attention", fa._SIGNATURES)
    smem = lib.repro_flash_attention_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int]
    res["ptxas"] = flash_ptxas(build_log)
    res["dynamic_smem_bytes"] = {f"hd{d}": smem(d) for d in (64, 128)}
    emit({"phase": "flash_attention", "B": B, "H": H, "hd": hd, "S": S, **res})
    return res


#: T1's cases: (name, B, H, Sq, Sk, causal, window, hd)
FLASH_BWD_CASES = [("minicpm", 1, 36, 2048, 2048, True, 0, 64),
                   ("granite", 1, 32, 2048, 2048, True, 0, 128),
                   ("window128", 1, 36, 2048, 2048, True, 128, 64),
                   ("window128_hd128", 1, 8, 2048, 2048, True, 128, 128),
                   ("window1", 1, 8, 300, 300, True, 1, 64),
                   ("ragged2050", 1, 36, 2050, 2050, True, 0, 64),
                   ("ragged2050_hd128", 1, 8, 2050, 2050, True, 0, 128),
                   ("ragged97_B2", 2, 8, 97, 97, True, 0, 64),
                   ("noncausal", 1, 32, 128, 2048, False, 0, 128),
                   ("noncausal_ragged", 1, 8, 65, 97, False, 0, 64),
                   ("window17_sq97_sk300", 2, 4, 97, 300, True, 17, 128),
                   ("qwen2_moe", 1, 16, 2048, 2048, True, 0, 128),
                   ("hymba_window2048", 1, 25, 4096, 4096, True, 2048, 64),
                   ("qwen2vl_2304", 1, 28, 2304, 2304, True, 0, 128),
                   ("whisper_B2", 2, 12, 2048, 2048, True, 0, 64)]


def flash_bwd_inputs(torch, B, H, Sq, Sk, hd, causal, window, g):
    """q, k, v, out, lse, dO on the card in the main path's layout ((B, S,
    H, hd) viewed as (B, H, S, hd)), dO ~ N(0, 1); out and lse are the plain
    forward in float64 rounded to fp32, so every input is an fp32 value."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(torch, B, H, Sq, Sk, hd, torch.float32, "bshd", g)
    do = torch.randn((B, Sq, H, hd), generator=g, device="cuda").transpose(1, 2)
    out64, lse64 = fa.flash_attention_plain(
        q.double(), k.double(), v.double(), causal=causal, window=window,
        return_lse=True)
    return q, k, v, torch.empty_like(q).copy_(out64), lse64.float(), do


def flash_bwd_ptxas(log: str) -> dict:
    """ptxas's report of the backward's three kernels at each head dim."""
    def key_of(name):
        for part in ("delta", "dkdv", "dq"):
            if f"flash_bwd_{part}_kernel" in name:
                hd = re.search(r"ILi(\d+)EE", name)
                return part + (f"_hd{hd.group(1)}" if hd else "")
        return None
    return ptxas_report(log, key_of)


def flash_backward_phase(torch, flush, build_log: str):
    """Gate T1 over ``FLASH_BWD_CASES``, the forward's lse against the plain
    version's, two launches bit-equal; then times with a cold L2 at
    minicpm-2b's and granite-8b's causal 2048, beside the bound, the plain
    version and the backward of ``scaled_dot_product_attention`` (a
    yardstick only)."""
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    cases = {}
    for name, B, H, Sq, Sk, causal, window, hd in FLASH_BWD_CASES:
        args = flash_bwd_inputs(torch, B, H, Sq, Sk, hd, causal, window, g)
        kw = {"causal": causal, "window": window}
        g64 = fa.flash_attention_bwd_plain(*(a.double() for a in args), **kw)
        g32 = fa.flash_attention_bwd_plain(*args, **kw)
        gk = fa.flash_attention_bwd_cuda(*args, **kw)
        again = fa.flash_attention_bwd_cuda(*args, **kw)
        _, lse_k = fa.flash_attention_cuda(*args[:3], return_lse=True, **kw)
        _, lse_p = fa.flash_attention_plain(*args[:3], return_lse=True, **kw)
        torch.cuda.synchronize()
        res = {"repeat_bit_equal": all(torch.equal(a, b)
                                       for a, b in zip(gk, again)),
               "lse_abs_err": (lse_k - lse_p).abs().max().item()}
        for part, a, b, c in zip(("dq", "dk", "dv"), gk, g32, g64):
            require(bool(torch.isfinite(a).all()), f"T1 {name} {part}")
            err = (a.double() - c).abs().max().item()
            err32 = (b.double() - c).abs().max().item()
            bound = 2 * err32 + 1e-6 * c.abs().max().item()
            res[part] = {"err": err, "err_fp32_plain": err32, "bound": bound,
                         "ratio": err / bound}
            require(err <= bound, f"gate T1 fails: {name} {part} {err} > "
                    f"{bound}")
        res["t1_ratio"] = max(res[p]["ratio"] for p in ("dq", "dk", "dv"))
        require(res["repeat_bit_equal"], f"T1 {name}: two launches differ")
        require(res["lse_abs_err"] <= 1e-5,
                f"T1 {name}: lse err {res['lse_abs_err']} > 1e-5")
        cases[name] = res

    def timed(B, H, S, hd, window=0):
        """Kernel, plain and SDPA-backward times at a causal S (under a
        sliding ``window``: SDPA with the same boolean mask), and the
        bound: the backward's five products over the unmasked pairs at
        the TF32 peak, against its bytes (q, k, v, out, dO, lse read, dq,
        dk, dv written); beside it the design's own floor, its 7 products
        a pair (S and dP in both passes) in 3xTF32 at the TF32 peak."""
        args = flash_bwd_inputs(torch, B, H, S, S, hd, True, window, g)
        pairs = B * H * (sum(min(i + 1, window) for i in range(S)) if window
                         else S * (S + 1) // 2)
        flops = 10 * hd * pairs
        nbytes = 4 * (8 * B * H * S * hd + B * H * S)
        kw = {"causal": True, "window": window}
        qs, ks, vs = (a.detach().requires_grad_(True) for a in args[:3])
        if window:
            i = torch.arange(S, device="cuda")
            keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
        else:
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        res = {"kernel_ms": time_ms(
            torch, lambda: fa.flash_attention_bwd_cuda(*args, **kw),
            flush=flush),
            "plain_ms": time_ms(
                torch, lambda: fa.flash_attention_bwd_plain(*args, **kw),
                iters=5, flush=flush),
            "library_ms": time_ms(
                torch, lambda: torch.autograd.grad(o, (qs, ks, vs), args[5],
                                                   retain_graph=True),
                flush=flush),
            "pairs": pairs, "flops": flops, "bytes": nbytes,
            "bound_3xtf32_ms": 3 * 7 * 2 * hd * pairs / PEAK_FLOPS["float32"]
            * 1e3,
            "bound_ms": max(flops / PEAK_FLOPS["float32"],
                            nbytes / HBM_BYTES_PER_S) * 1e3}
        res["bound_by"] = ("operations" if flops / PEAK_FLOPS["float32"]
                           >= nbytes / HBM_BYTES_PER_S else "bytes")
        return res

    lib = build.load("flash_attention_bwd", fa._BWD_SIGNATURES)
    smem = lib.repro_flash_attention_bwd_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
    res = {"cases": cases,
           "max_abs_err": max(c[p]["err"] for c in cases.values()
                              for p in ("dq", "dk", "dv")),
           "max_abs_err_minicpm": max(cases["minicpm"][p]["err"]
                                      for p in ("dq", "dk", "dv")),
           "t1_ratio": max(c["t1_ratio"] for c in cases.values()),
           "minicpm": timed(1, 36, 2048, 64), "granite": timed(1, 32, 2048, 128),
           "qwen2_moe": timed(1, 16, 2048, 128),
           # the training shapes of hymba-1.5b (H=25 under its 2048
           # window at S=4096), qwen2-vl-7b (256 patches + 2048 text) and
           # whisper-small's decoder (B=2)
           "hymba_window2048": timed(1, 25, 4096, 64, window=2048),
           "qwen2vl_2304": timed(1, 28, 2304, 128),
           "whisper_B2": timed(2, 12, 2048, 64),
           "ptxas": flash_bwd_ptxas(build_log),
           "dynamic_smem_bytes": {f"hd{d}": {"dkdv": smem(d, 0), "dq": smem(d, 1)}
                                  for d in (64, 128)}}
    emit({"phase": "flash_backward", **res})
    return res


def _gating_logits(torch, T, E, g, ties=False):
    """Router-like logits on the card; with ``ties`` every column appears
    twice and row 0 is uniform, so equal probabilities are common."""
    if ties:
        half = torch.randn((T, E // 2), generator=g, device="cuda") * 2
        x = torch.cat([half, half], dim=1)
        x[0] = 0.25
        return x.contiguous()
    return torch.randn((T, E), generator=g, device="cuda") * 2


def gating_phase(torch, flush):
    from repro_torch.kernels import moe_gating as mg

    g = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    cases = [(T, E, K, False) for T in GATING_T for E, K in GATING_EK]
    cases += [(T, 60, 4, True) for T in (8, 2050)]
    for T, E, K, ties in cases:
        x = _gating_logits(torch, T, E, g, ties)
        w, ids, probs = mg.moe_gating_cuda(x, K)
        wp, ip, pp = mg.moe_gating_plain(x, K)
        torch.cuda.synchronize()
        key = f"T{T}_E{E}_K{K}" + ("_ties" if ties else "")
        require(torch.equal(ids, ip), f"gating {key}: expert ids differ")
        errs[key] = max((w - wp).abs().max().item(),
                        (probs - pp).abs().max().item())
        require(errs[key] <= 1e-6, f"gating {key}: err {errs[key]} > 1e-6")

    # times at qwen2-moe-a2.7b's router: E=60, K=4; T=8 is one decode step
    # of 8 sessions, T=2048 one long prompt
    E, K = 60, 4

    def three_calls(x):
        # softmax, topk, divide: the same function but for the tie order
        # (torch.topk does not promise the lowest index first)
        p = torch.softmax(x, dim=-1)
        v, i = torch.topk(p, K, dim=-1)
        return v / torch.clamp_min(v.sum(-1, keepdim=True), 1e-9), i, p

    res = {"max_abs_err": errs, "max_abs_err_all": max(errs.values())}
    for T in (8, 2048):
        x = _gating_logits(torch, T, E, g)
        nbytes = 2 * T * E * 4 + T * K * 8     # logits in, probs + w + ids out
        ops = T * E * (5 + 2 * K)              # softmax, then K compare rounds
        res[f"T{T}"] = {
            "kernel_ms": time_ms(torch, lambda: mg.moe_gating_cuda(x, K),
                                 iters=50, flush=flush),
            "plain_ms": time_ms(torch, lambda: mg.moe_gating_plain(x, K),
                                iters=20, flush=flush),
            "softmax_topk_divide_ms": time_ms(torch, lambda: three_calls(x),
                                              iters=50, flush=flush),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / FP32_SIMT_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / FP32_SIMT_FLOPS else "operations"),
        }
    # no single PyTorch call computes softmax + ordered top-k + renormalise
    res["library_ms"] = None
    emit({"phase": "moe_gating", "E": E, "K": K, **res})
    return res


#: the router kernel's cases: (D, E, K) at every T of GATING_T
ROUTER_DEK = ((2048, 60, 4), (2048, 16, 4), (1024, 64, 8), (64, 60, 4))
#: the router kernel's cluster sizes, checked and timed at qwen2-moe-a2.7b's
#: router (D=2048, E=60, K=4) at T=8 and T=2048 beside the plan's own
ROUTER_CLUSTERS = (1, 2, 4, 8, 16)


def router_inputs(torch, T, D, E, g, scale=None, ties=False):
    """x ~ N(0, 1) (T, D) and a router ~ N(0, scale^2) (D, E), by default
    scale = 2 / sqrt(D), so the logits spread about 2 as the gating cases'
    own; with ``ties`` the router's columns come in equal pairs and x's row
    0 is zero, so twin logits are equal and row 0 is uniform."""
    scale = 2 / D ** 0.5 if scale is None else scale
    x = torch.randn((T, D), generator=g, device="cuda")
    if ties:
        half = torch.randn((D, E // 2), generator=g, device="cuda") * scale
        router = torch.cat([half, half], dim=1).contiguous()
        x[0] = 0
    else:
        router = torch.randn((D, E), generator=g, device="cuda") * scale
    return x, router


def router_check(torch, got, want, k, ties) -> dict:
    """The router kernel's bounds against its plain version: ids equal in
    every row whose plain K-th and (K+1)-th probabilities differ by more
    than TIE_GAP (every row for constructed ties), weights within 1e-6 on
    the rows whose ids agree, probabilities within 1e-6 on every row."""
    w, ids, probs = got
    wp, ip, pp = want
    near = topk_gap(pp, k) <= TIE_GAP
    agree = (ids == ip).all(dim=1)
    held = torch.ones_like(near) if ties else ~near
    require(bool(agree[held].all()), "router gating: expert ids differ")
    res = {"near_ties": int(near.sum()),
           "near_ties_ids_differ": int((near & ~agree).sum()),
           "w_err": (w - wp)[agree].abs().max().item() if agree.any() else 0.0,
           "probs_err": (probs - pp).abs().max().item()}
    require(res["w_err"] <= 1e-6 and res["probs_err"] <= 1e-6,
            f"router gating: {res}")
    return res


def router_ptxas(log: str) -> dict:
    """ptxas's report of the router kernel's instantiations and the empty
    kernel beside them."""
    def key_of(name):
        m = re.search(r"router_gating_kernelILi(\d+)E", name)
        if m:
            return f"rows{m.group(1)}"
        return "empty" if "router_empty_kernel" in name else None
    return ptxas_report(log, key_of)


def router_gating_phase(torch, flush, build_log: str = ""):
    """The router product + gating kernel against its plain version at
    every T of GATING_T and (D, E, K) of ROUTER_DEK, with the init's 0.02
    scale, constructed ties and every cluster size; two launches bit-equal;
    cold-L2 times at T=8 and T=2048 (by a rewrite and by a read) beside the
    old pair (cuBLAS product, then the logits-in kernel), the empty kernel
    at the same launch shape, the plain version, the four-call yardstick
    and the bound."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gating as mg

    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(T, D, E, K, None, False, None) for T in GATING_T
             for D, E, K in ROUTER_DEK]
    cases += [(2048, 2048, 60, 4, 0.02, False, None)]
    cases += [(T, 2048, 60, 4, None, True, None) for T in (8, 2050)]
    cases += [(T, 2048, 60, 4, None, False, c) for T in (8, 2048)
              for c in ROUTER_CLUSTERS]
    checks = {}
    for T, D, E, K, scale, ties, c in cases:
        x, router = router_inputs(torch, T, D, E, g, scale, ties)
        got = mg.router_gating_cuda(x, router, K, c)
        again = mg.router_gating_cuda(x, router, K, c)
        want = mg.router_gating_plain(x, router, K)
        torch.cuda.synchronize()
        key = (f"T{T}_D{D}_E{E}_K{K}" + (f"_scale{scale}" if scale else "")
               + ("_ties" if ties else "")
               + f"_C{mg.router_plan(T, D, c)[0]}")
        res = router_check(torch, got, want, K, ties)
        res["bit_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
        require(res["bit_repeat"], f"router gating {key}: not bit-repeatable")
        checks[key] = res

    lib = build.load("moe_gating", mg._SIGNATURES)
    D, E, K = 2048, 60, 4

    def four_calls(x, router):
        # product, softmax, topk, divide: the same function but for the tie
        # order (torch.topk does not promise the lowest index first)
        p = torch.softmax(x @ router, dim=-1)
        v, i = torch.topk(p, K, dim=-1)
        return v / torch.clamp_min(v.sum(-1, keepdim=True), 1e-9), i, p

    def cold(fn, iters=50):
        return {"rewrite": time_ms(torch, fn, iters=iters, flush=flush),
                "read": time_ms(torch, fn, iters=iters, flush=flush,
                                flush_by_read=True)}

    res = {"cases": checks,
           "max_abs_err": max(max(v["w_err"], v["probs_err"])
                              for v in checks.values())}
    for T in (8, 2048):
        x, router = router_inputs(torch, T, D, E, g)
        stream = torch.cuda.current_stream().cuda_stream

        def empty(c):
            plan = mg.router_plan(T, D, c)

            def run():
                require(lib.repro_router_gating_empty(T, D, *plan, stream)
                        == 0, "empty router launch failed")
            return run

        nbytes = (T * D + D * E) * 4 + T * (E * 4 + K * 8)
        ops = 2 * T * D * E + T * E * (5 + 2 * K)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_SIMT_FLOPS
        res[f"T{T}"] = {
            "kernel_ms": cold(lambda: mg.router_gating_cuda(x, router, K)),
            "by_cluster": {str(c): {
                "kernel_ms": cold(lambda: mg.router_gating_cuda(x, router, K,
                                                                c)),
                "empty_ms": cold(empty(c))} for c in ROUTER_CLUSTERS},
            "old_pair_ms": cold(lambda: mg.moe_gating_cuda(x @ router, K)),
            "empty_ms": cold(empty(None)),
            "plain_ms": time_ms(torch, lambda: mg.router_gating_plain(
                x, router, K), iters=20, flush=flush),
            "four_calls_ms": cold(lambda: four_calls(x, router)),
            "plan": dict(zip(("cluster", "chunk", "rows"),
                             mg.router_plan(T, D))),
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    smem = lib.repro_router_gating_smem_bytes
    res["dynamic_smem_bytes"] = {f"rows{rows}": smem(rows) for rows in
                                 (mg.ROWS_SHORT, mg.ROWS_LONG)}
    res["ptxas"] = router_ptxas(build_log)
    # no single PyTorch call computes the product, softmax, ordered top-k
    # and renormalisation
    res["library_ms"] = None
    emit({"phase": "router_gating", "D": D, "E": E, "K": K, **res})
    return res


#: gate R1's cases: (name, T, D, E, K, ties)
GATING_BWD_CASES = [("qwen_T2048", 2048, 2048, 60, 4, False),
                    ("qwen_T4096", 4096, 2048, 60, 4, False),
                    ("ragged97", 97, 2048, 60, 4, False),
                    ("reduced_E8K2", 4096, 256, 8, 2, False),
                    ("ties", 2050, 2048, 60, 4, True)]


def gating_bwd_inputs(torch, T, D, E, K, g, ties=False):
    """x, router (``router_inputs``), the plain forward's (weights, ids,
    probs), and dweights, dprobs ~ N(0, 1), all fp32 on the card."""
    from repro_torch.kernels import moe_gating as mg

    x, router = router_inputs(torch, T, D, E, g, ties=ties)
    w, ids, probs = mg.router_gating_plain(x, router, K)
    dw = torch.randn((T, K), generator=g, device="cuda")
    dp = torch.randn((T, E), generator=g, device="cuda")
    return x, router, w, ids, probs, dw, dp


def router_gating_backward_phase(torch, flush, build_log: str = ""):
    """Gate R1 over ``GATING_BWD_CASES``, two launches bit-equal; then
    times with a cold L2 at one training micro-batch of qwen2-moe-a2.7b
    (T=2048, D=2048, E=60, K=4): the kernel beside its bytes bound, an
    empty kernel of the same launch shape (the launch floor) and the plain
    version, and the wrapper with its two fp32 products beside the plain
    version's.  No single PyTorch call computes this VJP."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gating as mg

    g = torch.Generator(device="cuda").manual_seed(30)
    cases = {}
    for name, T, D, E, K, ties in GATING_BWD_CASES:
        args = gating_bwd_inputs(torch, T, D, E, K, g, ties)
        a64 = [a.double() if a.is_floating_point() else a for a in args]
        gk = (mg.gating_bwd_cuda(*args[2:]), *mg.router_gating_bwd_cuda(*args))
        again = mg.gating_bwd_cuda(*args[2:])
        g32 = (mg.gating_bwd_plain(*args[2:]),
               *mg.router_gating_bwd_plain(*args))
        g64 = (mg.gating_bwd_plain(*a64[2:]), *mg.router_gating_bwd_plain(*a64))
        torch.cuda.synchronize()
        res = {"repeat_bit_equal": torch.equal(gk[0], again)}
        for part, a, b, c in zip(("dlogits", "dx", "drouter"), gk, g32, g64):
            require(bool(torch.isfinite(a).all()), f"R1 {name} {part}")
            err = (a.double() - c).abs().max().item()
            err32 = (b.double() - c).abs().max().item()
            bound = 2 * err32 + 1e-6 * c.abs().max().item()
            res[part] = {"err": err, "err_fp32_plain": err32, "bound": bound,
                         "ratio": err / bound}
            require(err <= bound, f"gate R1 fails: {name} {part} {err} > "
                    f"{bound}")
        res["r1_ratio"] = max(res[p]["ratio"] for p in ("dlogits", "dx",
                                                         "drouter"))
        require(res["repeat_bit_equal"], f"R1 {name}: two launches differ")
        cases[name] = res

    lib = build.load("moe_gating_bwd", mg._BWD_SIGNATURES)
    T, D, E, K = 2048, 2048, 60, 4
    x, router, *gating = gating_bwd_inputs(torch, T, D, E, K, g)
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        require(lib.repro_gating_bwd_empty(T, stream) == 0,
                "empty gating backward launch failed")

    # probs, dprobs read, dlogits written; weights, ids, dweights read
    nbytes = 4 * (3 * T * E + 3 * T * K)
    # p * dp, its row sum, dp - dot, p * (...) an element; a selected
    # expert's sum, c's product and sum, dw / s, - c / s and its add
    ops = 4 * T * E + 6 * T * K
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_SIMT_FLOPS
    timed = {
        "kernel_ms": time_ms(torch, lambda: mg.gating_bwd_cuda(*gating),
                             iters=50, flush=flush),
        "empty_ms": time_ms(torch, empty, iters=50, flush=flush),
        "plain_ms": time_ms(torch, lambda: mg.gating_bwd_plain(*gating),
                            iters=20, flush=flush),
        "with_products_ms": time_ms(
            torch, lambda: mg.router_gating_bwd_cuda(x, router, *gating),
            iters=20, flush=flush),
        "plain_with_products_ms": time_ms(
            torch, lambda: mg.router_gating_bwd_plain(x, router, *gating),
            iters=20, flush=flush),
        "bytes": nbytes, "ops": ops,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # the two products alone: 2 * T * D * E FLOP each at the fp32 rate
        "products_bound_ms": max(4 * T * D * E / FP32_SIMT_FLOPS,
                                 4 * (2 * T * D + 2 * D * E + T * E)
                                 / HBM_BYTES_PER_S) * 1e3,
    }
    res = {"cases": cases,
           "max_abs_err": max(c[p]["err"] for c in cases.values()
                              for p in ("dlogits", "dx", "drouter")),
           "max_abs_err_dlogits_T2048": cases["qwen_T2048"]["dlogits"]["err"],
           "r1_ratio": max(c["r1_ratio"] for c in cases.values()),
           "T2048": timed,
           "ptxas": ptxas_report(
               build_log, lambda n: ("gating_bwd" if "gating_bwd_kernel" in n
                                     else "empty" if "gating_bwd_empty" in n
                                     else None)),
           # no single PyTorch call computes the gating's VJP
           "library_ms": None}
    emit({"phase": "router_gating_backward", "D": D, "E": E, "K": K, **res})
    return res


def mlstm_inputs(torch, B, H, S, hd, state, g, dev="cuda"):
    """The JAX kernel test's distributions, on the card (or ``dev``): q, k
    (pre-scaled by 1/sqrt(hd)), v, log i ~ N(0,1), log f =
    log_sigmoid(N(0,1) + 2); the start state "empty" (m = -1e30), "cache"
    (a serving cache's zeros, m = 0) or "warm" (0.1·N(0,1) memory, m =
    0.5)."""
    q, k, v = (torch.randn((B, H, S, hd), generator=g, device=dev)
               for _ in range(3))
    li = torch.randn((B, H, S), generator=g, device=dev)
    lf = torch.nn.functional.logsigmoid(
        torch.randn((B, H, S), generator=g, device=dev) + 2.0)
    C0 = torch.zeros((B, H, hd, hd), device=dev)
    n0 = torch.zeros((B, H, hd), device=dev)
    if state == "warm":
        C0 = 0.1 * torch.randn((B, H, hd, hd), generator=g, device=dev)
        n0 = 0.1 * torch.randn((B, H, hd), generator=g, device=dev)
    m0 = torch.full((B, H), {"empty": -1e30, "cache": 0.0, "warm": 0.5}[state],
                    device=dev)
    return [q, k / hd ** 0.5, v, li, lf, C0, n0, m0]


def mlstm_g1(torch, out, args):
    """Gate G1 on the kernel's outputs ``out`` for ``args``: the plain
    version in float64 on the card is ``ref``, in float32 ``p32``.  h:
    max|h - ref| <= 2 max|h_p32 - ref| + 1e-6 max|ref|; C and n within
    2e-5 of their largest reference entry; m within 2e-5 max(1, |m_ref|).
    Returns the readings, each ``*_over_limit`` <= 1 on a pass."""
    from repro_torch.kernels import mlstm_scan as ms

    p32 = ms.mlstm_scan_plain(*args)
    ref = ms.mlstm_scan_plain(*(a.double() for a in args))
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t).all()) for t in out),
            "mlstm: non-finite kernel output")

    def err(a, b):
        return (a.double() - b).abs().max().item()

    h_abs, p32_abs = err(out[0], ref[0]), err(p32[0], ref[0])
    h_limit = 2 * p32_abs + 1e-6 * ref[0].abs().max().item()
    res = {"h_abs": h_abs, "h_plain_fp32_abs": p32_abs, "h_limit": h_limit,
           "h_over_limit": h_abs / h_limit}
    for name, a, b in zip("Cn", out[1:3], ref[1:3]):
        res[f"{name}_rel"] = err(a, b) / b.abs().max().item()
        res[f"{name}_over_limit"] = res[f"{name}_rel"] / 2e-5
    res["m_abs"] = err(out[3], ref[3])
    res["m_over_limit"] = ((out[3].double() - ref[3]).abs()
                           / (2e-5 * ref[3].abs().clamp_min(1.0))).max().item()
    return res


def g1_holds(res) -> bool:
    return all(v <= 1.0 for k, v in res.items() if k.endswith("_over_limit"))


def mlstm_work(B, H, S, hd, W):
    """The least work of the scan in chunks of W rows: per head and row
    q·C and the update's (k·wk)ᵀ·v (2 hd² FLOP each), and per chunk of Wc
    rows the causal half of q kᵀ and of P·v (hd Wc (Wc + 1) FLOP each);
    the bytes each input and output moves once; and, for comparison with
    earlier rows, the TPU kernel's four products at full W x W (no causal
    saving) with W by the model's chunk rule."""
    chunks = [min(W, S - t0) for t0 in range(0, S, W)]
    flops = B * H * (4 * S * hd * hd
                     + 2 * hd * sum(w * (w + 1) for w in chunks))
    nbytes = 4 * (4 * B * H * S * hd + 2 * B * H * S + 2 * B * H * hd * hd
                  + 2 * B * H * hd + 2 * B * H)
    Wt = 256 if S % 256 == 0 else S
    flops_w256 = B * H * (S // Wt) * (4 * Wt * Wt * hd + 4 * Wt * hd * hd)
    return flops, nbytes, flops_w256


#: (name, B, H, S, hd, start): xlstm-1.3b's widths (H = 4, hd = 1024) for
#: a 2048-token prompt from a serving cache, a ragged prompt, a batch from
#: a warm state and one decode row, then the JAX kernel test's fp32 shapes
MLSTM_CASES = [("S2048_cache", 1, 4, 2048, 1024, "cache"),
               ("S300_cache", 1, 4, 300, 1024, "cache"),
               ("B2_S512_warm", 2, 4, 512, 1024, "warm"),
               ("S1_warm", 1, 4, 1, 1024, "warm"),
               ("jax_1x1x128x64", 1, 1, 128, 64, "empty"),
               ("jax_2x2x256x64", 2, 2, 256, 64, "empty"),
               ("jax_1x2x256x128", 1, 2, 256, 128, "empty"),
               ("jax_2x1x512x256", 2, 1, 512, 256, "empty")]


def prep_ms(torch, lib, args, flush) -> float:
    """Time of the mLSTM kernel's first pass alone (a part of the scan's
    time), launched through its C entry with the scratch made beforehand,
    so that the wrapper's host work is not timed."""
    from repro_torch.kernels import mlstm_scan as ms

    q, k, _, li, lf, _, _, m0 = args
    B, H, S, hd = q.shape
    buf = torch.empty(ms.scratch_layout(lib, B * H, S, hd)[1][-1],
                      device="cuda")
    m_T = torch.empty_like(m0)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        require(lib.repro_mlstm_prep(
            q.data_ptr(), k.data_ptr(), li.data_ptr(), lf.data_ptr(),
            m0.data_ptr(), buf.data_ptr(), m_T.data_ptr(), B * H, S, hd,
            stream) == 0, "mlstm prep launch failed")
    return time_ms(torch, run, iters=10, flush=flush)


def mlstm_phase(torch, flush, build_log: str):
    """The mLSTM kernel under gate G1 at every case, with its time (cold
    L2) and its first pass's, the plain version's, the bound from the
    scan's least work at the kernel's chunk width (and, beside it, from
    the TPU kernel's work, as earlier rows were), and ptxas's report of
    its two kernels."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_scan as ms

    lib = build.load("mlstm_scan", ms._SIGNATURES)
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = {}
    for name, B, H, S, hd, start in MLSTM_CASES:
        args = mlstm_inputs(torch, B, H, S, hd, start, g)
        res = mlstm_g1(torch, ms.mlstm_scan_cuda(*args), args)
        require(g1_holds(res), f"mlstm {name}: gate G1 fails: {res}")
        W = ms.scratch_layout(lib, B * H, S, hd)[0]
        flops, nbytes, flops_w256 = mlstm_work(B, H, S, hd, W)
        t_ops = flops / PEAK_FLOPS["float32"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        res.update({
            "kernel_ms": time_ms(torch, lambda: ms.mlstm_scan_cuda(*args),
                                 iters=10, flush=flush),
            "prep_ms": prep_ms(torch, lib, args, flush),
            "plain_ms": time_ms(torch, lambda: ms.mlstm_scan_plain(*args),
                                iters=5, flush=flush),
            "chunk": W, "flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop_w256": flops_w256,
            "bound_ms_w256": max(flops_w256 / PEAK_FLOPS["float32"],
                                 t_bytes) * 1e3})
        cases[name] = res
        del args
    # no single PyTorch call computes the chunkwise mLSTM recurrence
    emit({"phase": "mlstm", "cases": cases, "ptxas": mlstm_ptxas(build_log),
          "walk_dynamic_smem_bytes": lib.repro_mlstm_walk_smem_bytes(1024),
          "library_ms": None})
    return cases


#: gate X1's cases: rows of ``MLSTM_CASES``, and the training case, B=1,
#: H=4, S=2048, hd=1024 from C = n = 0, m = -1e30 (timed)
MLSTM_BWD_CASES = [c for c in MLSTM_CASES if c[0] in (
    "S2048_cache", "S300_cache", "B2_S512_warm", "jax_2x2x256x64")] + [
    ("S2048_empty", 1, 4, 2048, 1024, "empty")]
MLSTM_BWD_PARTS = ("dq", "dk", "dv", "dlog_i", "dlog_f", "dC0", "dn0", "dm0")


def mlstm_backward_phase(torch, flush, device="cuda", cases=None):
    """Gate X1: ``MLSTMScan`` (``ops.mlstm_scan`` under grad) over
    ``MLSTM_BWD_CASES``, inputs from ``mlstm_inputs`` and the cotangents of
    h, C_T, n_T and m_T ~ N(0, 1) from a seeded generator.  The forward
    under grad equals ``ops.mlstm_scan`` under no_grad to the bit, and
    launches the kernel once; the backward launches nothing.  With g64
    autograd straight through ``mlstm_scan_plain`` in float64 and g32 the
    same in fp32, each of the eight gradients g holds max|g - g64| <= 2
    max|g32 - g64| + 1e-6 max|g64|, and reads all zero where g64 does.
    Printed, not held: at S2048_empty, the backward's ms beside the
    forward kernel's and the fp32 plain autograd backward's, cold L2.
    ``device="cpu"`` with small ``cases`` rehearses it on the CPU (no
    launches, no times)."""
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import ops

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    g = torch.Generator(device=device).manual_seed(36)
    out, timed = {}, None
    for name, B, H, S, hd, start in cases or MLSTM_BWD_CASES:
        args = mlstm_inputs(torch, B, H, S, hd, start, g, device)
        shapes = (args[0].shape, args[5].shape, args[6].shape, args[7].shape)
        cots = [torch.randn(sh, generator=g, device=device) for sh in shapes]
        with torch.no_grad():
            want = ops.mlstm_scan(*args)
        xs = [a.detach().requires_grad_() for a in args]
        ops.reset_launch_counts()
        outs = ops.mlstm_scan(*xs)
        fwd_counts = ops.launch_counts()
        grads = torch.autograd.grad(outs, xs, cots, retain_graph=on_card)
        sync()
        counts = ops.launch_counts()
        require(type(outs[0].grad_fn).__name__ == "MLSTMScanBackward",
                f"X1 {name}: ops.mlstm_scan under grad took "
                f"{type(outs[0].grad_fn).__name__}")
        once = {k: int(on_card and k == "mlstm_scan") for k in counts}
        require(fwd_counts == once and counts == once,
                f"X1 {name}: launches {fwd_counts} forward, {counts} with "
                f"the backward, want {once}")
        require(all(torch.equal(a.detach(), b) for a, b in zip(outs, want)),
                f"X1 {name}: the forward under grad is not the no-grad one")

        def plain_grads(dtype, keep=False):
            x = [a.detach().to(dtype).requires_grad_() for a in args]
            o = ms.mlstm_scan_plain(*x)
            return x, o, torch.autograd.grad(
                o, x, [c.to(dtype) for c in cots], retain_graph=keep)
        g64 = plain_grads(torch.float64)[2]
        g32 = plain_grads(torch.float32)[2]
        res = {}
        for part, a, b, c in zip(MLSTM_BWD_PARTS, grads, g32, g64):
            require(bool(torch.isfinite(a).all()), f"X1 {name} {part}")
            err = (a.double() - c).abs().max().item()
            err32 = (b.double() - c).abs().max().item()
            scale = c.abs().max().item()
            bound = 2 * err32 + 1e-6 * scale
            res[part] = {"err": err, "err_fp32_plain": err32, "bound": bound,
                         "ratio": err / bound if bound else 0.0,
                         "g64_all_zero": scale == 0}
            require(scale > 0 or not bool(a.ne(0).any()),
                    f"gate X1 fails: {name} {part} is nonzero where g64 is "
                    "all zero")
            require(err <= bound, f"gate X1 fails: {name} {part} {err} > "
                    f"{bound}")
        res["x1_ratio"] = max(res[p]["ratio"] for p in MLSTM_BWD_PARTS)
        out[name] = res
        if on_card and name == "S2048_empty":
            x32, o32 = plain_grads(torch.float32, keep=True)[:2]
            timed = {
                "backward_ms": time_ms(torch, lambda: torch.autograd.grad(
                    outs, xs, cots, retain_graph=True), iters=5, flush=flush),
                "kernel_forward_ms": time_ms(
                    torch, lambda: ms.mlstm_scan_cuda(*args), iters=10,
                    flush=flush),
                "plain_fp32_autograd_backward_ms": time_ms(
                    torch, lambda: torch.autograd.grad(
                        o32, x32, cots, retain_graph=True), iters=5,
                    flush=flush)}
            del x32, o32
        del args, xs, outs, grads, g64, g32
    line = {"phase": "mlstm_backward", "gate": "X1", "device": device,
            "cases": out, "x1_ratio": max(c["x1_ratio"] for c in out.values()),
            "timed_S2048_empty": timed,
            "nvidia_smi": nvidia_smi() if on_card else None}
    emit(line)
    return line


# --------------------------------------------------------------- serving

def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode ``steps`` greedy steps (or replay
    ``feed``), close.  Returns per-prompt prefill logits and seconds, the
    per-step logits and seconds, the token feed, and each session's cache
    bytes before the close."""
    import numpy as np

    sessions = [f"s{i}" for i in range(len(prompts))]
    first, prefill_s = [], []
    for sid, p in zip(sessions, prompts):
        t0 = time.perf_counter()
        out, _ = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        prefill_s.append(time.perf_counter() - t0)   # out is on the host
        first.append(out[0])
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, step_s, fed = [], [], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        t0 = time.perf_counter()
        out, served, _ = eng.step(sessions, x)
        step_s.append(time.perf_counter() - t0)
        require(served == sessions, "a session was dropped")
        logits.append(out)
        toks = np.argmax(out, axis=-1).astype(np.int32)
    held = [eng._slot_kv_bytes(eng.by_session[sid]) for sid in sessions]
    eng.close(sessions)
    return np.stack(first), prefill_s, logits, step_s, fed, held


@contextlib.contextmanager
def recording_gating():
    """Keep every router gating's (expert ids, probabilities) in call
    order, on their device (nothing is copied or synchronised while the
    run goes on).  The counted kernel wrapper still does the work."""
    from repro_torch.kernels import ops

    real, rec = ops.router_gating, []

    def record(x, router, k):
        out = real(x, router, k)
        rec.append((out[1], out[2]))
        return out

    ops.router_gating = record
    try:
        yield rec
    finally:
        ops.router_gating = real


def _gating_by_call(rec, rows, L, steps, per_slot):
    """A run's gating records keyed by call: ("prefill", prompt, layer)
    with a row per token, ("step", t, layer) with a row per session.  The
    records come in the engine's order of work, which ``BatchEngine``'s
    docstring states: a prefill goes prompt by prompt, each through every
    layer; a fused step goes layer by layer over all sessions; a per-slot
    step goes session by session, each through every layer (its rows are
    stacked here).  Every record's row count is checked against that order,
    so a change of it fails here, or as a routing difference that is no
    tie."""
    import torch

    n = len(rows)
    calls = n * L + steps * L * (n if per_slot else 1)
    require(len(rec) in (0, calls), f"{len(rec)} gating calls, want {calls}")
    if not rec:
        return {}
    out = {("prefill", p, j): rec[p * L + j] for p in range(n) for j in range(L)}
    base = n * L
    for t in range(steps):
        for j in range(L):
            if per_slot:
                parts = [rec[base + (t * n + s) * L + j] for s in range(n)]
                out[("step", t, j)] = (torch.cat([r[0] for r in parts]),
                                       torch.cat([r[1] for r in parts]))
            else:
                out[("step", t, j)] = rec[base + t * L + j]
    for key, (ids, _) in out.items():
        want = rows[key[1]] if key[0] == "prefill" else n
        require(ids.shape[0] == want, f"gating call {key} has "
                f"{ids.shape[0]} rows, want {want}")
    return out


def routing_ties(rec_a, rec_b, rows, L, steps, k, b_per_slot=False):
    """Where two runs of one token feed first sent a token of a session to
    a different set of experts.  That decision must be a rounding tie in
    both runs (the k-th and (k+1)-th probabilities within ``TIE_GAP``);
    anything else fails.  From there on the session's states differ, so
    its later decisions are not compared.  ``rows`` are the prompt
    lengths.  Returns {session: {"step": the first step whose logits the
    tie reaches (-1: its prefill), "layer", "gaps"}}.

    At most half the sessions may reach a tie.  A real tie is rare (the
    full-width run met one in eight sessions, the reduced runs none),
    while a fault that flattens the probabilities (gating zeros, say)
    makes every decision a tie; the cap keeps such a run from passing by
    leaving its sessions out of the logit comparison."""
    n = len(rows)
    a = _gating_by_call(rec_a, rows, L, steps, False)
    b = _gating_by_call(rec_b, rows, L, steps, b_per_slot)
    reach = {}
    for key, (ids_a, probs_a) in a.items():         # in the order of the run
        ids_b, probs_b = b[key]
        differ = (ids_a.sort(dim=1).values.cpu()
                  != ids_b.sort(dim=1).values.cpu()).any(dim=1)
        for r in differ.nonzero()[:, 0].tolist():
            sess, step = (key[1], -1) if key[0] == "prefill" else (r, key[1])
            if sess in reach:
                continue
            gaps = []
            for probs in (probs_a[r], probs_b[r]):
                top = probs.float().cpu().topk(k + 1).values
                gaps.append(float(top[k - 1] - top[k]))
            require(max(gaps) <= TIE_GAP, f"routing differs at {key} row {r} "
                    f"with probability gaps {gaps}")
            reach[sess] = {"step": step, "layer": key[2], "gaps": gaps}
    require(len(reach) <= n // 2, f"routing ties reach {len(reach)} of {n} "
            "sessions")
    return reach


def int8_trace(rec_a, rec_b, run_a, run_b, rows, L, steps, k):
    """Where an int8-pool run of a feed parts from the fp32 run (``a``).
    Prefills are the same dense fp32 pass in both, so the runs first differ
    in decode step 0, layer 0's attention.  Per session: the first (step,
    layer) whose expert set differs, the K-th minus (K+1)-th probability
    there in both runs (a routing flip of a near tie if the fp32 gap is
    within ``TIE_GAP``), and the largest logit deviation before and from
    that step on.  Also the largest probability deviation by layer in step
    0, which is what int8 k/v does to the router before any flip."""
    import numpy as np
    import torch

    n = len(rows)
    a = _gating_by_call(rec_a, rows, L, steps, False)
    b = _gating_by_call(rec_b, rows, L, steps, False)
    prefill_same = all(torch.equal(a[key][0], b[key][0]) for key in a
                       if key[0] == "prefill")
    first = {}
    for t in range(steps):
        for j in range(L):
            ids_a, probs_a = a[("step", t, j)]
            ids_b, probs_b = b[("step", t, j)]
            differ = (ids_a.sort(dim=1).values.cpu()
                      != ids_b.sort(dim=1).values.cpu()).any(dim=1)
            for r in differ.nonzero()[:, 0].tolist():
                if r in first:
                    continue
                gaps = []
                for probs in (probs_a[r], probs_b[r]):
                    top = probs.float().cpu().topk(k + 1).values
                    gaps.append(float(top[k - 1] - top[k]))
                first[r] = {"step": t, "layer": j, "fp32_gap": gaps[0],
                            "int8_gap": gaps[1],
                            "tie": gaps[0] <= TIE_GAP,
                            "max_abs_prob_dev": float(
                                (probs_a[r] - probs_b[r]).abs().max())}
    dev = np.stack([np.abs(x - y).max(axis=-1)
                    for x, y in zip(run_a[2], run_b[2])])     # (steps, n)
    since = [first[s]["step"] if s in first else steps for s in range(n)]
    before = [float(dev[:since[s], s].max()) for s in range(n) if since[s]]
    after = [float(dev[since[s]:, s].max()) for s in range(n)
             if since[s] < steps]
    return {"prefill_routing_same": prefill_same,
            "first_routing_difference": {str(s): v for s, v in
                                         sorted(first.items())},
            "sessions_never_rerouted": n - len(first),
            "max_abs_logit_dev_before_first_difference":
                max(before) if before else None,
            "max_abs_logit_dev_from_first_difference":
                max(after) if after else None,
            "max_abs_logit_dev_per_step": dev.max(axis=1).tolist(),
            "step0_max_abs_prob_dev_by_layer": [
                float((a[("step", 0, j)][1] - b[("step", 0, j)][1]).abs()
                      .max()) for j in range(L)]}


def logit_diff(run_a, run_b, reach):
    """Max |a - b| over two runs' prefill and step logits, leaving out each
    session from the step a routing tie first reached."""
    import numpy as np

    first_a, steps_a = run_a[0], run_a[2]
    first_b, steps_b = run_b[0], run_b[2]
    n = len(first_a)
    since = [reach[s]["step"] if s in reach else len(steps_a) for s in range(n)]
    keep = [s for s in range(n) if since[s] > -1]
    diffs = [float(np.abs(first_a[keep] - first_b[keep]).max())]
    for t, (a, b) in enumerate(zip(steps_a, steps_b)):
        keep = [s for s in range(n) if since[s] > t]
        diffs.append(float(np.abs(a[keep] - b[keep]).max()))
    return max(diffs)


def expected_launches(cfg, prompts, steps):
    """Every kernel launch of one served run: paged attention per layer per
    step, flash per layer per long prompt, gating per layer per pass; for
    xLSTM (no attention, served per slot) the mLSTM scan per mLSTM layer
    per prefill, since a prefill against the cache takes the chunkwise
    form, and none in decode; for the hybrid arch (served per slot, its
    Mamba plain PyTorch) flash per layer per long prompt, none in
    decode."""
    from repro_torch.models import decoder

    L = cfg.n_layers
    n_long = sum(p.shape[1] >= 2048 for p in prompts)
    if cfg.arch == "hybrid":
        return {"paged_decode_attention": 0, "flash_attention": L * n_long,
                "flash_attention_bwd": 0, "moe_gating": 0,
                "moe_gating_bwd": 0, "mlstm_scan": 0}
    if cfg.arch == "ssm":
        n_mlstm = sum(not decoder._is_slstm(cfg, j) for j in range(L))
        return {"paged_decode_attention": 0, "flash_attention": 0,
                "flash_attention_bwd": 0, "moe_gating": 0,
                "moe_gating_bwd": 0, "mlstm_scan": n_mlstm * len(prompts)}
    return {"paged_decode_attention": L * steps, "flash_attention": L * n_long,
            "flash_attention_bwd": 0,
            "moe_gating": L * (len(prompts) + steps) if cfg.arch == "moe" else 0,
            "moe_gating_bwd": 0, "mlstm_scan": 0}


def small_parity_phase(torch):
    """Reduced models served on the card (through the kernels) and on the
    CPU (plain versions) with the same weights and token feed: granite-8b
    and qwen2-moe-a2.7b (its 60 experts, top-4, and a narrow expert width),
    each with fp32 and int8 pools.  fp32: 1e-4.  int8: k/v differ by fp32
    rounding between the devices, so an element on a rounding edge can
    quantize one step apart: 1e-2, far below the int8-vs-fp32 deviation.
    A routing difference must be a tie (``routing_ties``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.params import params_from_numpy, params_to_numpy
    from repro_torch.serving import BatchEngine, ShardModule

    cases = (("granite-8b", {}, (("fp32", 1e-4), ("int8", 1e-2))),
             ("qwen2-moe-a2.7b", dict(n_experts=60, moe_top_k=4, d_expert=32),
              (("fp32", 1e-4), ("int8", 1e-2))))
    steps = 6
    for seed, (name, kw, pools) in enumerate(cases, start=2):
        cfg = dataclasses.replace(get_config(name).reduced(), **kw)
        L = cfg.n_layers
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = decoder.init_params(cfg, gen, "cuda")
        cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
                   for n in (2048, 5, 40)]
        want = expected_launches(cfg, prompts, steps)
        errs, ties = {}, {}
        for kv_dtype, tol in pools:
            runs, counts, recs = {}, {}, {}
            for device, p in (("cuda", params), ("cpu", cpu_params)):
                sim = Sim(seed=0)
                eng = BatchEngine(ShardModule(cfg, p, (0, L), True, True), sim,
                                  n_slots=4, page_size=32, kv_dtype=kv_dtype,
                                  device=device)
                ops.reset_launch_counts()
                with recording_gating() as recs[device]:
                    runs[device] = _drive(
                        eng, sim, prompts, steps,
                        None if device == "cuda" else runs["cuda"][4])
                counts[device] = ops.launch_counts()
            require(counts["cuda"] == want and not any(counts["cpu"].values()),
                    f"small_parity {name} {kv_dtype} launches: {counts}, "
                    f"want {want} on the card only")
            reach = routing_ties(recs["cuda"], recs["cpu"],
                                 [p.shape[1] for p in prompts], L, steps,
                                 cfg.moe_top_k)
            errs[kv_dtype] = logit_diff(runs["cuda"], runs["cpu"], reach)
            ties[kv_dtype] = reach
            require(errs[kv_dtype] <= tol, f"card vs CPU {name} {kv_dtype} "
                    f"logits differ by {errs[kv_dtype]}")
        emit({"phase": "small_parity", "config": f"{name} reduced(L={L}, "
              f"d={cfg.d_model}, vocab={cfg.vocab}"
              + (f", E={cfg.n_experts}, K={cfg.moe_top_k}, "
                 f"d_expert={cfg.d_expert})" if cfg.arch == "moe" else ")"),
              "launches_cuda": want, "max_abs_logit_err": errs,
              "tolerance": {k: t for k, t in pools},
              "routing_ties": {k: {str(s): t for s, t in r.items()}
                               for k, r in ties.items()}})


def served_three_ways(torch, cfg, seed, prompts, steps, device="cuda",
                      params=None):
    """Serve a reduced ``cfg`` per slot through ``BatchEngine`` three
    times on one seeded init (or on ``params``, on ``device``): on
    ``device`` in float32 (the "card32" run),
    then on the CPU in float32 and in float64, both fed the card32 run's
    greedy tokens.  Returns each run's ``_drive`` tuple and launch counts,
    and the per-call max|card32 - cpu64| and max|cpu32 - cpu64| (each
    prefill's row, then each step)."""
    import numpy as np

    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.params import params_from_numpy, params_to_numpy
    from repro_torch.serving import BatchEngine, ShardModule

    L = cfg.n_layers
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = decoder.init_params(cfg, gen, device)
    tree = params_to_numpy(params)
    runs = {"card32": params,
            "cpu32": params_from_numpy(tree, "cpu"),
            "cpu64": params_from_numpy(_cast_tree(tree, np.float64), "cpu")}
    out, counts = {}, {}
    for name, p in runs.items():
        sim = Sim(seed=0)
        eng = BatchEngine(ShardModule(cfg, p, (0, L), True, True), sim,
                          n_slots=len(prompts), page_size=32,
                          device=device if name == "card32" else "cpu")
        require(not eng.fused, f"{cfg.name} must serve per slot")
        ops.reset_launch_counts()
        out[name] = _drive(eng, sim, prompts, steps,
                           None if name == "card32" else out["card32"][4])
        counts[name] = ops.launch_counts()
    require(not any(counts["cpu32"].values())
            and not any(counts["cpu64"].values()),
            f"the CPU runs launched kernels: {counts}")
    require(out["cpu64"][0].dtype == np.float64, "the fp64 run is not fp64")

    def diffs(a, b):          # max |a - b| per prefill row and per step
        return ([float(np.abs(a[0][i] - b[0][i]).max())
                 for i in range(len(prompts))]
                + [float(np.abs(x - y).max()) for x, y in zip(a[2], b[2])])

    return (out, counts, diffs(out["card32"], out["cpu64"]),
            diffs(out["cpu32"], out["cpu64"]))


def xlstm_parity_phase(torch):
    """Gate G2: a reduced xlstm-1.3b (L=8, so block 7 is the sLSTM;
    d=256, vocab 512, mLSTM head dim 128) served through ``BatchEngine``
    on the card in float32, then on the CPU in float32 and in float64 on
    the same weights and the card's greedy feed.  Over every prefill's
    and step's logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 -
    cpu64|).  The card launches the mLSTM kernel in the 7 mLSTM layers of
    every prefill, the CPU never."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config("xlstm-1.3b").reduced(n_layers=8)
    L = cfg.n_layers
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in XLSTM_SMALL_PROMPTS]
    want = expected_launches(cfg, prompts, XLSTM_SMALL_STEPS)
    require(want["mlstm_scan"] == 7 * len(prompts), f"launches {want}")
    _, counts, card, cpu = served_three_ways(torch, cfg, 5, prompts,
                                             XLSTM_SMALL_STEPS)
    require(counts["card32"] == want, f"card launches {counts['card32']}, "
            f"want {want}")
    limit = max(1e-4, 2 * max(cpu))
    emit({"phase": "small_parity", "config": f"xlstm-1.3b reduced(L={L}, "
          f"d={cfg.d_model}, vocab={cfg.vocab}, slstm_every="
          f"{cfg.slstm_every})", "prompts": XLSTM_SMALL_PROMPTS,
          "decode_steps": XLSTM_SMALL_STEPS, "launches_cuda": want,
          "max_abs_logit_err": {"card32_vs_cpu64": max(card),
                                "cpu32_vs_cpu64": max(cpu)},
          "g2_limit": limit, "card32_vs_cpu64_per_call": card,
          "cpu32_vs_cpu64_per_call": cpu})
    require(max(card) <= limit, f"gate G2 fails: card32 vs cpu64 {max(card)} "
            f"> {limit}")


def hybrid_parity_phase(torch, device="cuda", prompts=None):
    """Gate Y1: a reduced hymba-1.5b (``HYBRID_REDUCED``: L=4, d=256, H=4,
    Hk=1, hd=64, window 64, ssm_state 8, d_inner 512) served per slot
    through ``BatchEngine`` on ``device`` (the card) in float32, then on
    the CPU in float32 and in float64 on the same weights and the card's
    greedy feed: ``HYBRID_SMALL_PROMPTS`` (two through the flash branch;
    64 fills the ring exactly; 100, 200 and 300 take the masked branch
    over the ring, the reference's hazard; 12 and 37 wrap it in decode),
    ``HYBRID_SMALL_STEPS`` greedy steps.  Over every prefill's and step's
    logits: max|card32 - cpu64| <= max(1e-4, 2 max|cpu32 - cpu64|).  The
    card launches ``flash_attention`` once per layer per prompt of at
    least ``FLASH_MIN_SEQ`` tokens (4 x 2), nothing else; the CPU runs
    launch nothing.  ``device="cpu"`` (with shorter ``prompts``) rehearses
    the phase on the CPU, where no run launches."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config("hymba-1.5b").reduced(**HYBRID_REDUCED)
    L = cfg.n_layers
    lengths = HYBRID_SMALL_PROMPTS if prompts is None else prompts
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in lengths]
    want = expected_launches(cfg, prompts, HYBRID_SMALL_STEPS)
    if device == "cuda":
        require(want["flash_attention"] == L * 2
                and sum(want.values()) == L * 2, f"launches {want}")
    else:
        want = {k: 0 for k in want}
    t0 = time.perf_counter()
    out, counts, card, cpu = served_three_ways(
        torch, cfg, 7, prompts, HYBRID_SMALL_STEPS, device)
    require(counts["card32"] == want, f"card launches {counts['card32']}, "
            f"want {want}")
    limit = max(1e-4, 2 * max(cpu))
    line = {"phase": "hybrid_parity", "config": f"hymba-1.5b reduced(L={L}, "
            f"d={cfg.d_model}, H={cfg.n_heads}, Hk={cfg.n_kv_heads}, "
            f"window={cfg.window}, ssm_state={cfg.ssm_state}, d_inner="
            f"{cfg.d_in}, vocab={cfg.vocab})", "device": device,
            "prompts": list(lengths), "decode_steps": HYBRID_SMALL_STEPS,
            "launches_card32": counts["card32"],
            "max_abs_logit_err": {"card32_vs_cpu64": max(card),
                                  "cpu32_vs_cpu64": max(cpu)},
            "y1_limit": limit, "card32_vs_cpu64_per_call": card,
            "cpu32_vs_cpu64_per_call": cpu,
            "seconds": time.perf_counter() - t0}
    emit(line)
    require(max(card) <= limit, f"gate Y1 fails: card32 vs cpu64 {max(card)} "
            f"> {limit}")
    return line


#: T2: a reduced minicpm-2b (hd=64, so the kernels take it) at B=2, S=2048
T2_REDUCED = {"n_layers": 2, "d_model": 256, "vocab": 256}
T2_STEPS = 3


def train_parity_phase(torch):
    """Gate T2: a reduced minicpm-2b trained on the card in fp32 and on the
    CPU in fp32 and float64 from the same state and batches, with 1 and 2
    micro-batches: step 1's gradient leaves (each over its leaf's largest
    |cpu64| entry), then each of three steps' loss and grad norm, within
    max(1e-4, 2 max|cpu32 - cpu64|) of cpu64.  The card launches the flash
    forward and backward in every layer of every micro-batch, the CPU
    never."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.optim import constant_schedule
    from repro_torch.tree import leaves
    from repro_torch.params import train_state_to_numpy
    from repro_torch.train import make_train_step, train_state_init

    cfg = get_config("minicpm-2b").reduced(**T2_REDUCED)
    require(cfg.hd == 64, f"reduced head dim {cfg.hd}")
    base = train_state_to_numpy(
        train_state_init(cfg, torch.Generator().manual_seed(7), "cpu"))
    data = make_batch_iterator(cfg.vocab, 2048, 2, seed=7)
    batches = [next(data) for _ in range(T2_STEPS)]
    out = {}
    for mb in (1, 2):
        runs = {}
        for name, dev, dt in (("card32", "cuda", np.float32),
                              ("cpu32", "cpu", np.float32),
                              ("cpu64", "cpu", np.float64)):
            state = t2_state(base, dt, dev)
            require(leaves(state.params)[0].dtype == torch.as_tensor(
                np.zeros(1, dt)).dtype, f"{name} is not {dt}")
            step = make_train_step(cfg, constant_schedule(1e-3),
                                   microbatches=mb)
            ops.reset_launch_counts()
            _, _, grads = step.grads_of(state.params, {
                k: torch.as_tensor(v, device=dev)
                for k, v in batches[0].items()})
            grads = [g.double().cpu() for g in leaves(grads)]
            hist = []
            for b in batches:
                state, m = step(state, b)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            runs[name] = (grads, hist, ops.launch_counts())
            del state, step
        card, c32, c64 = (runs[k] for k in ("card32", "cpu32", "cpu64"))
        L = cfg.n_layers
        want = {k: 0 for k in card[2]}
        want["flash_attention"] = L * mb * (1 + T2_STEPS)
        want["flash_attention_bwd"] = want["flash_attention"]
        require(card[2] == want, f"T2 mb={mb} card launches {card[2]} != "
                f"{want}")
        require(not any(c32[2].values()) and not any(c64[2].values()),
                f"T2 mb={mb}: the CPU runs launched kernels")
        grad_ratio, step_ratio = t2_ratios(card, c32, c64)
        out[f"mb{mb}"] = {
            "loss_grad_norm": {k: runs[k][1] for k in runs},
            "grad_leaf_ratio_to_bound_max": max(grad_ratio),
            "step_ratio_to_bound": step_ratio, "launches_cuda": card[2]}
        require(max(grad_ratio) <= 1.0,
                f"gate T2 fails: mb={mb} gradient leaves {grad_ratio}")
        require(max(max(r) for r in step_ratio) <= 1.0,
                f"gate T2 fails: mb={mb} loss / grad norm {step_ratio}")
    emit({"phase": "train_parity", "config": f"minicpm-2b reduced("
          f"L={cfg.n_layers}, d={cfg.d_model}, H={cfg.n_heads}, hd={cfg.hd}, "
          f"vocab={cfg.vocab})", "batch": 2, "seq": 2048, "steps": T2_STEPS,
          **out})


#: T2m: a reduced qwen2-moe-a2.7b (hd=64, so the flash kernels take it)
#: with 8 experts, top-2 and a capacity factor of 1.0, under which tokens
#: drop (``reduced`` alone sets 8.0)
T2M_REDUCED = {"n_layers": 2, "d_model": 256, "vocab": 256, "n_experts": 8,
               "moe_top_k": 2, "capacity_factor": 1.0}
#: at most this share of a run's gating rows may be ties that the CPU's
#: own top-k orders otherwise than the card
T2M_TIE_SHARE = 0.01


def topk_gap(probs, k):
    """Each row's K-th minus (K+1)-th largest probability (inf at K = E)."""
    if k >= probs.shape[1]:
        return probs.new_full(probs.shape[:1], float("inf"))
    top = probs.topk(k + 1, dim=1).values
    return top[:, k - 1] - top[:, k]


@contextlib.contextmanager
def replaying_gating(records, seen):
    """For a CPU run of gate T2m: ``RouterGating``'s plain forward computes
    the plain probabilities and takes the card's expert ids of the same
    call (``records``, in call order), weights the gathered probabilities
    over their clamped sum, summed in selection order as the plain forward
    sums them.  Each call's own top-k is computed too: ``seen`` gets, per
    call, (the rows whose expert set differs from the card's, every row's
    K-th minus (K+1)-th probability).  The port has no replay argument:
    this swaps the module's plain forward for the run."""
    import torch

    from repro_torch.kernels import moe_gating as mg

    real = mg.router_gating_plain

    def replay(x, router, k):
        i = len(seen)
        require(i < len(records), f"T2m: gating call {i} past the card's "
                f"{len(records)}")
        ids = records[i].to(x.device)
        require(tuple(ids.shape) == (x.shape[0], k), f"T2m: gating call {i} "
                f"has {x.shape[0]} rows x {k}, the card's {tuple(ids.shape)}")
        _, own, probs = real(x, router, k)
        sel = probs.gather(1, ids.long())
        total = torch.zeros_like(sel[:, :1])
        for j in range(k):
            total = total + sel[:, j:j + 1]
        differ = (own.sort(dim=1).values != ids.sort(dim=1).values).any(dim=1)
        seen.append((differ.nonzero()[:, 0], topk_gap(probs, k)))
        return sel / torch.clamp_min(total, 1e-9), ids, probs

    mg.router_gating_plain = replay
    try:
        yield seen
    finally:
        mg.router_gating_plain = real


def dropped_by_call(cfg, records):
    """Per gating call, the (token, k) pairs past their expert's capacity
    (the training drop), from the call's expert ids."""
    from repro_torch.models.moe import capacity

    out = []
    for ids in records:
        T = ids.shape[0]
        G = (cfg.moe_groups if cfg.moe_groups > 1 and T % cfg.moe_groups == 0
             else 1)
        C = capacity(cfg, T // G, False)
        load = [ids.reshape(G, -1)[g].long().bincount(minlength=cfg.n_experts)
                for g in range(G)]
        out.append(int(sum((n - C).clamp_min(0).sum().item() for n in load)))
    return out


def moe_train_parity_phase(torch, device="cuda"):
    """Gate T2m: a reduced qwen2-moe-a2.7b trained on the card in fp32 and
    on the CPU in fp32 and float64 from the same state and batches, with 1
    and 2 micro-batches, the CPU runs replaying the card's routing: step
    1's gradient leaves (each over its leaf's largest |cpu64| entry), then
    each of three steps' loss, aux and grad norm, within max(1e-4, 2
    max|cpu32 - cpu64|) of cpu64; rows the CPU would route otherwise only
    cpu64 ties, at most 1% of the rows; tokens dropped in some layer.  The
    card launches the flash forward and backward, the router kernel and
    the gating backward in every layer of every micro-batch, the CPU
    never.  ``device="cpu"`` rehearses it on the CPU at S=64."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.optim import constant_schedule
    from repro_torch.params import train_state_to_numpy
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import leaves

    cfg = get_config("qwen2-moe-a2.7b").reduced(**T2M_REDUCED)
    require(cfg.hd == 64 and cfg.arch == "moe", f"T2m config {cfg}")
    S = 2048 if device == "cuda" else 64
    base = train_state_to_numpy(
        train_state_init(cfg, torch.Generator().manual_seed(30), "cpu"))
    data = make_batch_iterator(cfg.vocab, S, 2, seed=30)
    batches = [next(data) for _ in range(T2_STEPS)]
    L, K = cfg.n_layers, cfg.moe_top_k
    out = {}
    for mb in (1, 2):
        runs, records, seen = {}, [], {}
        for name, dev, dt in (("card32", device, np.float32),
                              ("cpu32", "cpu", np.float32),
                              ("cpu64", "cpu", np.float64)):
            state = t2_state(base, dt, dev)
            step = make_train_step(cfg, constant_schedule(1e-3),
                                   microbatches=mb)
            if name == "card32":
                ctx = recording_gating()
            else:
                ctx = replaying_gating([r.cpu() for r in records],
                                       seen.setdefault(name, []))
            ops.reset_launch_counts()
            with ctx as rec:
                _, _, grads = step.grads_of(state.params, {
                    k: torch.as_tensor(v, device=dev)
                    for k, v in batches[0].items()})
                grads = [g.double().cpu() for g in leaves(grads)]
                hist = []
                for b in batches:
                    state, m = step(state, b)
                    hist.append([float(m[k]) for k in ("loss", "aux",
                                                       "grad_norm")])
            if name == "card32":
                records = [ids for ids, _ in rec]
            runs[name] = (grads, hist, ops.launch_counts())
            del state, step
        calls = L * mb * (1 + T2_STEPS)
        require(len(records) == calls and all(len(seen[k]) == calls
                                              for k in seen),
                f"T2m mb={mb}: gating calls {len(records)}, "
                f"{ {k: len(v) for k, v in seen.items()} }, want {calls}")
        card, c32, c64 = (runs[k] for k in ("card32", "cpu32", "cpu64"))
        want = {k: 0 for k in card[2]}
        for k in ("flash_attention", "flash_attention_bwd", "moe_gating",
                  "moe_gating_bwd"):
            want[k] = L * mb * (1 + T2_STEPS) if device == "cuda" else 0
        require(card[2] == want, f"T2m mb={mb} card launches {card[2]} != "
                f"{want}")
        require(not any(c32[2].values()) and not any(c64[2].values()),
                f"T2m mb={mb}: the CPU runs launched kernels")
        # routing: a row the CPU would route otherwise must be a cpu64 tie
        rows = sum(r.shape[0] for r in records)
        gaps64 = [gap for _, gap in seen["cpu64"]]
        differ = {}
        for name in ("cpu32", "cpu64"):
            for i, (idx, _) in enumerate(seen[name]):
                for r in idx.tolist():
                    differ[(i, r)] = float(gaps64[i][r])
        require(all(g <= TIE_GAP for g in differ.values()),
                f"T2m mb={mb}: rows routed otherwise on the CPU are no "
                f"ties: {differ}")
        require(len(differ) <= T2M_TIE_SHARE * rows,
                f"T2m mb={mb}: {len(differ)} of {rows} rows routed otherwise")
        drops = dropped_by_call(cfg, records)
        # call i: pass i // (mb L), micro-batch (i // L) % mb, layer i % L
        by_pass_layer = [[sum(drops[p * mb * L + m * L + j] for m in range(mb))
                          for j in range(L)] for p in range(1 + T2_STEPS)]
        require(max(drops) > 0, f"T2m mb={mb}: no token dropped")
        grad_ratio, step_ratio = t2_ratios(card, c32, c64)
        out[f"mb{mb}"] = {
            "loss_aux_grad_norm": {k: runs[k][1] for k in runs},
            "grad_leaf_ratio_to_bound_max": max(grad_ratio),
            "step_ratio_to_bound": step_ratio, "launches_cuda": card[2],
            "dropped_by_pass_and_layer": by_pass_layer,
            "slots_by_call": [r.numel() for r in records],
            "smallest_cpu64_gap": min(float(g.min()) for g in gaps64),
            "rows": rows, "rows_routed_otherwise": len(differ),
            "routed_otherwise": {f"{i}:{r}": g for (i, r), g in
                                 sorted(differ.items())[:20]}}
        require(max(grad_ratio) <= 1.0,
                f"gate T2m fails: mb={mb} gradient leaves {grad_ratio}")
        require(max(max(r) for r in step_ratio) <= 1.0,
                f"gate T2m fails: mb={mb} loss / aux / grad norm {step_ratio}")
    emit({"phase": "moe_train_parity", "config": f"qwen2-moe-a2.7b reduced("
          f"L={cfg.n_layers}, d={cfg.d_model}, H={cfg.n_heads}, hd={cfg.hd}, "
          f"vocab={cfg.vocab}, E={cfg.n_experts}, K={K}, d_expert="
          f"{cfg.d_exp}, capacity_factor={cfg.capacity_factor})",
          "batch": 2, "seq": S, "steps": T2_STEPS, **out})
    return out


#: T2h, T2v, T2a, T2x: arch -> (gate, its reduced config, as Y1, V1, A1
#: and G2 serve it (xlstm-1.3b at 8 layers, so that layer 7 is its
#: sLSTM), text tokens at S=2048: qwen2-vl's 16 patches + 2032), the
#: multiple k of the fp32 CPU run's error in the gate's bound
#: (``t2_ratios``).  T2x's 16 is twice the largest reading of a sound
#: card run at the gate's inputs, rounded up to a power of two: the port
#: on the card with the mLSTM forward through the plain scan read 6.02
#: times cpu32's error (scripts/t2_witness.py)
T2_ARCHS = {"hymba-1.5b": ("T2h", HYBRID_REDUCED, 2048, 2),
            "qwen2-vl-7b": ("T2v", VLM_REDUCED, 2032, 2),
            "whisper-small": ("T2a", {}, 2048, 2),
            "xlstm-1.3b": ("T2x", {"n_layers": 8}, 2048, 16)}


def train_launches(cfg, passes):
    """The kernels ``passes`` forward-and-backward passes of ``cfg``'s
    train step launch: the flash forward and backward once per (decoder)
    layer each, or for xLSTM the mLSTM kernel once per mLSTM layer (its
    backward launches none, and the sLSTM none)."""
    from repro_torch.models.decoder import _is_slstm

    if cfg.arch == "ssm":
        return {"mlstm_scan": passes * sum(
            not _is_slstm(cfg, i) for i in range(cfg.n_layers))}
    return {"flash_attention": cfg.n_layers * passes,
            "flash_attention_bwd": cfg.n_layers * passes}


def train_batches(cfg, n_text, B, seed):
    """``launch.train``'s batch stream (tokens and labels) for ``cfg``,
    each batch with its arch's stub inputs as ``stub_batch`` draws them:
    for vlm ``n_patches`` patch embeddings ~ N(0, 1) on a square grid of
    ``positions3`` before the text, for audio frames ~ N(0, 1)."""
    from repro_torch.data import make_batch_iterator

    for i, batch in enumerate(make_batch_iterator(cfg.vocab, n_text, B,
                                                  seed=seed)):
        extra = stub_batch(cfg, n_text, B, seed + 1 + i)
        del extra["tokens"]
        yield {**batch, **extra}


def t2_inputs(torch, arch, n_text=None, cfg=None, seed=7):
    """Gate T2h's, T2v's, T2a's or T2x's config, its numpy start state and
    its ``T2_STEPS`` batches (B=2) of ``n_text`` text tokens from
    ``train_batches``, both drawn from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.params import train_state_to_numpy
    from repro_torch.train import train_state_init

    _, reduced, text, _ = T2_ARCHS[arch]
    cfg = cfg or get_config(arch).reduced(**reduced)
    base = train_state_to_numpy(
        train_state_init(cfg, torch.Generator().manual_seed(seed), "cpu"))
    data = train_batches(cfg, text if n_text is None else n_text, 2,
                         seed=seed)
    return cfg, base, [next(data) for _ in range(T2_STEPS)]


def t2_run(torch, cfg, base, batches, mb, dtype, device):
    """One run of a T2-form gate: ``base`` cast to ``dtype`` on
    ``device``, then a step per batch through ``make_train_step``'s
    ``grads_of`` and ``update`` (so step 1's gradients are the step's
    own).  Returns (step 1's gradient leaves as float64 numpy arrays,
    [(loss, grad norm)] per step, the launch counts of the run)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import constant_schedule
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves

    state = t2_state(base, dtype, device)
    step = make_train_step(cfg, constant_schedule(1e-3), microbatches=mb)
    ops.reset_launch_counts()
    first, hist = None, []
    for b in batches:
        loss, m, grads = step.grads_of(state.params, {
            k: torch.as_tensor(v, device=device) for k, v in b.items()})
        if first is None:
            # a copy: the update clips the gradients in place, and a
            # float64 leaf on the CPU is its own .double().cpu()
            first = [g.double().cpu().numpy().copy() for g in leaves(grads)]
        state, m = step.update(state, loss, m, grads)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        del grads
    return first, hist, ops.launch_counts()


def t2_cpu_runs(cfg, base, batches, threads=None):
    """The CPU runs of a T2-form gate, fp32 and float64 at 1 and 2
    micro-batches: {(name, mb): ``t2_run``'s result}.  The smoke runs them
    in a spawned worker (``spawn_pool``) while the card serves, with
    ``threads`` intra-op threads."""
    import numpy as np
    import torch

    import repro_torch  # noqa: F401  (turns TF32 off, as the smoke does)

    if threads:
        torch.set_num_threads(threads)
    return {(name, mb): t2_run(torch, cfg, base, batches, mb, dt, "cpu")
            for mb in (1, 2)
            for name, dt in (("cpu32", np.float32), ("cpu64", np.float64))}


@contextlib.contextmanager
def spawn_pool():
    """One spawned worker process, terminated when the block ends,
    whatever happens."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        yield pool
    finally:
        pool.terminate()
        pool.join()


def arch_train_parity_phase(torch, arch, device="cuda", n_text=None,
                            cfg=None, cpu_runs=None):
    """Gates T2h, T2v, T2a, T2x: T2's form on the reduced config of
    ``arch`` that Y1, V1, A1 or G2 serves, B=2, S=2048 (qwen2-vl: 16
    patches + 2032 text tokens), from one state and one batch stream
    (``t2_inputs``), with 1 and 2 micro-batches, on the card in fp32 and
    on the CPU in fp32 and float64: three steps, each through
    ``make_train_step``'s ``grads_of`` then its ``update``; step 1's
    gradient leaves (each over its leaf's largest |cpu64| entry) and each
    step's loss and grad norm within max(1e-4, k max|cpu32 - cpu64|) of
    cpu64, k the gate's multiple in ``T2_ARCHS`` (2; T2x 16); a leaf whose
    cpu64 gradient is all zero (an xLSTM layer's idle branch) all zero in
    every run.  The card launches the flash forward and backward once per
    (decoder) layer per micro-batch per step, L x mb x 3 each (xLSTM: the
    mLSTM kernel once per mLSTM layer, 7 x mb x 3), nothing else
    (``train_launches``); the CPU runs launch nothing.
    ``cpu_runs`` is ``t2_cpu_runs`` of the same inputs, computed
    elsewhere (the smoke's worker), else here.  ``device="cpu"`` with a
    short ``n_text`` (and a narrower ``cfg``) rehearses it on the CPU."""
    import numpy as np

    t0 = time.perf_counter()
    gate, _, _, k = T2_ARCHS[arch]
    cfg, base, batches = t2_inputs(torch, arch, n_text, cfg)
    require(device == "cpu" or cfg.hd == 64,
            f"{gate}: reduced head dim {cfg.hd}")
    L = cfg.n_layers
    seq = batches[0]["tokens"].shape[1] + (cfg.n_patches if cfg.arch == "vlm"
                                           else 0)
    if cpu_runs is None:
        cpu_runs = t2_cpu_runs(cfg, base, batches)
    out = {}
    for mb in (1, 2):
        runs = {"card32": t2_run(torch, cfg, base, batches, mb, np.float32,
                                 device)}
        runs.update((name, cpu_runs[(name, mb)]) for name in ("cpu32",
                                                               "cpu64"))
        card, c32, c64 = ((list(map(torch.from_numpy, runs[k][0])),
                           *runs[k][1:]) for k in ("card32", "cpu32", "cpu64"))
        want = {k: 0 for k in card[2]}
        if device == "cuda":
            want.update(train_launches(cfg, mb * T2_STEPS))
        require(card[2] == want, f"{gate} mb={mb} card launches {card[2]} "
                f"!= {want}")
        require(not any(c32[2].values()) and not any(c64[2].values()),
                f"{gate} mb={mb}: the CPU runs launched kernels")
        grad_ratio, step_ratio = t2_ratios(card, c32, c64, k)
        out[f"mb{mb}"] = {
            "loss_grad_norm": {name: run[1] for name, run in runs.items()},
            "grad_leaf_ratio_to_bound_max": max(grad_ratio),
            "step_ratio_to_bound": step_ratio, "launches_cuda": card[2],
            "grad_leaves_all_zero": sum(not bool(c.ne(0).any())
                                        for c in c64[0])}
        require(max(grad_ratio) <= 1.0,
                f"gate {gate} fails: mb={mb} gradient leaves {grad_ratio}")
        require(max(max(r) for r in step_ratio) <= 1.0,
                f"gate {gate} fails: mb={mb} loss / grad norm {step_ratio}")
    line = {"phase": f"{cfg.arch}_train_parity", "gate": gate,
            "config": f"{arch} reduced(L={L}, d={cfg.d_model}, "
            f"H={cfg.n_heads}, Hk={cfg.n_kv_heads}, hd={cfg.hd}, "
            f"window={cfg.window}, vocab={cfg.vocab})", "device": device,
            "batch": 2, "seq": seq, "steps": T2_STEPS, "k": k, **out,
            "seconds": time.perf_counter() - t0}
    emit(line)
    return line


def t2_state(base, dtype, device):
    """The numpy train state ``base`` cast to ``dtype`` (its params and
    both moments) on ``device``."""
    from repro_torch.params import train_state_from_numpy

    return train_state_from_numpy(base._replace(
        params=_cast_tree(base.params, dtype), opt=type(base.opt)(
            base.opt.step, _cast_tree(base.opt.mu, dtype),
            _cast_tree(base.opt.nu, dtype))), device)


def t2_ratios(card, c32, c64, k=2):
    """T2's readings over its bound, for runs (step 1's gradient leaves,
    each step's metrics, ...): each leaf's max|card32 - cpu64| over
    max(1e-4, k max|cpu32 - cpu64|), both over the leaf's largest |cpu64|
    entry; each step metric's the same without the scale.  A leaf whose
    cpu64 gradient is all zero (a branch the loss does not reach) reads 0
    when it is all zero in the other runs too, else infinity."""
    grad_ratio = []
    for a, b, c in zip(card[0], c32[0], c64[0]):
        scale = c.abs().max().item()
        if scale == 0:
            grad_ratio.append(math.inf if bool(a.ne(0).any())
                              or bool(b.ne(0).any()) else 0.0)
            continue
        err = (a - c).abs().max().item() / scale
        bound = max(1e-4, k * (b - c).abs().max().item() / scale)
        grad_ratio.append(err / bound)
    step_ratio = [[abs(a - c) / max(1e-4, k * abs(b - c))
                   for a, b, c in zip(x, y, z)]
                  for x, y, z in zip(card[1], c32[1], c64[1])]
    return grad_ratio, step_ratio


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.astype(dtype)


def serving_phase(torch, arch, phase):
    """Serve ``arch`` at full width and depth in fp32 through the fused
    engine, then replay its token feed through the per-slot path (the
    reference) and the int8 pool, and profile a few steps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.serving import BatchEngine, ShardModule
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module = ShardModule(cfg, params, (0, L), is_first=True, is_last=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in SERVE_PROMPTS]
    want = expected_launches(cfg, prompts, SERVE_STEPS)

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device="cuda")
    ops.reset_launch_counts()
    with recording_gating() as rec:
        run = _drive(eng, sim, prompts, SERVE_STEPS)
    counts = ops.launch_counts()
    first, prefill_s, logits, step_s, feed, _ = run
    pages_after = eng.stats["pages"]
    peak = torch.cuda.max_memory_allocated()
    require(pages_after == 0, f"pages after close: {pages_after}")
    require(counts == want, f"{arch} launches {counts} != {want}")
    for out in [first] + logits:
        require(out.shape == (len(prompts), cfg.vocab), f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    emit({"phase": phase, "model": cfg.name, "n_layers": L,
          "d_model": cfg.d_model, "params": sum(
              t.numel() for t in leaves(params)),
          "init_s": init_s, "prompts": SERVE_PROMPTS,
          "prefill_ms": [s * 1e3 for s in prefill_s],
          "decode_steps": SERVE_STEPS,
          "decode_ms_per_step_median": statistics.median(step_s) * 1e3,
          "tokens_per_s": len(prompts) * SERVE_STEPS / sum(step_s),
          "launches": counts, "pages_after_close": pages_after,
          "max_memory_allocated_bytes": peak})
    del eng
    torch.cuda.empty_cache()

    # replay the recorded feed: the per-slot path is the reference
    sim = Sim(seed=0)
    ref = BatchEngine(module, sim, n_slots=8, page_size=32, fused=False,
                      device="cuda")
    with recording_gating() as r_rec:
        r_run = _drive(ref, sim, prompts, SERVE_STEPS, feed)
    del ref
    torch.cuda.empty_cache()
    reach = routing_ties(rec, r_rec, SERVE_PROMPTS, L, SERVE_STEPS,
                         cfg.moe_top_k, b_per_slot=True)
    del r_rec
    diff = logit_diff(run, r_run, reach)
    agree = float(np.mean([np.array_equal(np.argmax(a, -1), np.argmax(b, -1))
                           for a, b in zip(logits, r_run[2])]))
    require(diff <= 1e-3, f"fused vs per-slot logits differ by {diff}")

    sim = Sim(seed=0)
    q8 = BatchEngine(module, sim, n_slots=8, page_size=32, kv_dtype="int8",
                     device="cuda")
    with recording_gating() as q_rec:
        q_run = _drive(q8, sim, prompts, SERVE_STEPS, feed)
    q_logits, q_step_s = q_run[2], q_run[3]
    del q8
    torch.cuda.empty_cache()
    dev8 = max(float(np.abs(a - b).max()) for a, b in zip(q_logits, logits))
    if cfg.arch == "moe":
        emit({"phase": f"{phase}_int8_trace", **int8_trace(
            rec, q_rec, run, q_run, SERVE_PROMPTS, L, SERVE_STEPS,
            cfg.moe_top_k)})
    del rec, q_rec
    emit({"phase": f"{phase}_replay",
          "per_slot_max_abs_logit_diff": diff, "tolerance": 1e-3,
          "per_slot_routing_ties": {str(s): t for s, t in reach.items()},
          "per_slot_greedy_agreement": agree,
          "per_slot_decode_ms_per_step_median":
              statistics.median(r_run[3]) * 1e3,
          "int8_max_abs_logit_dev": dev8,
          "int8_decode_ms_per_step_median": statistics.median(q_step_s) * 1e3})
    profile_decode(torch, module, prompts, feed)
    return counts


@contextlib.contextmanager
def recording_mlstm():
    """Keep every mLSTM scan's (inputs, outputs) in call order; the
    counted kernel wrapper still does the work."""
    from repro_torch.kernels import ops

    real, rec = ops.mlstm_scan, []

    def record(*args):
        out = real(*args)
        rec.append((args, out))
        return out

    ops.mlstm_scan = record
    try:
        yield rec
    finally:
        ops.mlstm_scan = real


def serving_xlstm_phase(torch):
    """Serve xlstm-1.3b at full width and depth in fp32 through the
    per-slot engine, every prefill's mLSTM layers through the kernel, under
    gate G3; then the state handoff checks (G3) with gate G1 on the
    kernel's real inputs, and a profile of a few decode steps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.tree import leaves
    from repro_torch.serving import BatchEngine, ShardModule

    cfg = get_config("xlstm-1.3b")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = decoder.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module = ShardModule(cfg, params, (0, L), is_first=True, is_last=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in XLSTM_PROMPTS]
    want = expected_launches(cfg, prompts, SERVE_STEPS)
    require(want["mlstm_scan"] == 42 * len(prompts), f"launches {want}")

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device="cuda")
    require(not eng.fused, "xlstm must serve per slot")
    ops.reset_launch_counts()
    first, prefill_s, logits, step_s, feed, held = _drive(
        eng, sim, prompts, SERVE_STEPS)
    counts = ops.launch_counts()
    pages_after = eng.stats["pages"]
    peak = torch.cuda.max_memory_allocated()
    del eng
    emit({"phase": "serving_xlstm", "model": cfg.name, "n_layers": L,
          "d_model": cfg.d_model,
          "params": sum(t.numel() for t in leaves(params)),
          "init_s": init_s, "prompts": XLSTM_PROMPTS,
          "prefill_ms": [t * 1e3 for t in prefill_s],
          "decode_steps": SERVE_STEPS,
          "decode_ms_per_step_median": statistics.median(step_s) * 1e3,
          "tokens_per_s": len(prompts) * SERVE_STEPS / sum(step_s),
          "launches": counts, "pages_after_close": pages_after,
          "state_bytes_per_session": held,
          "max_memory_allocated_bytes": peak})
    for out in [first] + logits:
        require(out.shape == (len(prompts), cfg.vocab), f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    require(counts == want, f"xlstm launches {counts} != {want}")
    require(pages_after == 0, f"pages after close: {pages_after}")
    require(held == [XLSTM_STATE_BYTES] * len(prompts),
            f"state bytes per session {held}")

    tokens = torch.from_numpy(prompts[0]).cuda()          # the 2048 prompt
    handoff_by_layer(torch, cfg, params, tokens)
    handoff_end_to_end(torch, cfg, params, {"tokens": tokens})
    profile_decode(torch, module, prompts, feed)
    return counts


def serving_hybrid_phase(torch, device="cuda", cfg=None,
                         prompts=HYBRID_PROMPTS):
    """Gate Y2: hymba-1.5b at full width and depth in fp32 served per slot
    (8 sessions, page 32, ``HYBRID_PROMPTS``, 32 greedy steps), every
    prefill of at least 2048 tokens through the flash kernel at window
    2048: finite logits; ``flash_attention`` launched 32 x 3 times,
    nothing else; 0 pages after close; no session holds more than
    ``HYBRID_STATE_BYTES`` of cache, and every one whose length reached
    the window holds exactly that.  Then ``launch.serve.main`` on the
    card (a 2100-token prompt, 8 tokens), gate Y3's handoff on the first
    prompt (4096 tokens), layer by layer and end to end, and a profile of
    a few steps.  ``device="cpu"`` with a reduced ``cfg`` and short
    ``prompts`` rehearses it on the CPU (no launches, no profile)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import decoder
    from repro_torch.serving import BatchEngine, ShardModule
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    full = cfg is None
    cfg = get_config("hymba-1.5b") if full else cfg
    L = cfg.n_layers
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = decoder.init_params(cfg, gen, device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module = ShardModule(cfg, params, (0, L), is_first=True, is_last=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in prompts]
    lengths = [p.shape[1] for p in prompts]
    want = expected_launches(cfg, prompts, SERVE_STEPS)
    if full:
        require(want["flash_attention"] == 32 * 3
                and sum(want.values()) == 32 * 3, f"launches {want}")
    if not on_card:
        want = {k: 0 for k in want}
    # one session's cache at the window: k and v, h and conv, every layer
    at_window = L * (2 * cfg.window * cfg.n_kv_heads * cfg.hd * 4
                     + cfg.d_in * cfg.ssm_state * 4 + 3 * cfg.d_in * 4)
    if full:
        require(at_window == HYBRID_STATE_BYTES, f"{at_window} bytes")

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device=device)
    require(not eng.fused, "hymba must serve per slot")
    ops.reset_launch_counts()
    first, prefill_s, logits, step_s, feed, held = _drive(
        eng, sim, prompts, SERVE_STEPS)
    counts = ops.launch_counts()
    pages_after = eng.stats["pages"]
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del eng
    line = {"phase": "serving_hybrid", "model": cfg.name, "n_layers": L,
            "d_model": cfg.d_model, "window": cfg.window,
            "params": sum(t.numel() for t in leaves(params)),
            "init_s": init_s, "prompts": lengths,
            "prefill_ms": [t * 1e3 for t in prefill_s],
            "decode_steps": SERVE_STEPS,
            "decode_ms_per_step_median": statistics.median(step_s) * 1e3,
            "tokens_per_s": len(prompts) * SERVE_STEPS / sum(step_s),
            "launches": counts, "pages_after_close": pages_after,
            "cache_bytes_per_session": held,
            "cache_bytes_at_window": at_window,
            "max_memory_allocated_bytes": peak}
    emit(line)
    for out in [first] + logits:
        require(out.shape == (len(prompts), cfg.vocab), f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    require(counts == want, f"hymba launches {counts} != {want}")
    require(pages_after == 0, f"pages after close: {pages_after}")
    for n, b in zip(lengths, held):
        require(b <= at_window, f"a session of {n} tokens holds {b} bytes")
        require(n + SERVE_STEPS < cfg.window or b == at_window,
                f"a session past the window holds {b} bytes, not {at_window}")

    # the launcher, once, on the same device
    t0 = time.perf_counter()
    argv = ["--arch", "hymba-1.5b", "--prompt-len", "2100", "--gen", "8",
            "--batch", "1", "--device", device]
    serve_vocab = cfg.vocab
    if not full:
        argv[3] = "100"
        argv.append("--reduced")
        serve_vocab = get_config("hymba-1.5b").reduced().vocab
    toks = serve.main(argv)
    serve_s = time.perf_counter() - t0
    require(toks.shape == (1, 8) and bool((toks >= 0).all())
            and bool((toks < serve_vocab).all()), f"launch.serve gave {toks}")

    tokens = torch.from_numpy(prompts[0]).to(device)
    t0 = time.perf_counter()
    handoff_by_layer_hybrid(torch, cfg, params, tokens)
    handoff_end_to_end(torch, cfg, params, {"tokens": tokens},
                       "hybrid_handoff")
    handoff_s = time.perf_counter() - t0
    if on_card:
        # two steps: the profiler's bookkeeping of ~25,000 launches a
        # per-slot step is most of this phase's seconds
        profile_decode(torch, module, prompts, feed, steps=2)
    emit({"phase": "serving_hybrid_done", "serve_cli_s": serve_s,
          "handoff_s": handoff_s,
          "seconds": time.perf_counter() - t_phase})
    return counts


def handoff_by_layer_hybrid(torch, cfg, params, tokens):
    """Gate Y3's handoff, layer by layer: each layer, fed the input that
    prefill(S) gives it (all fp32), runs prefill(S) and prefill(S - 1) +
    one decode step from a fresh cache (a ring of ``cfg.window`` slots);
    the Mamba h and conv tail and the ring's k and v, slot for slot, lie
    within 1e-4 of their largest entry."""
    import dataclasses

    from repro_torch.models import decoder

    one = dataclasses.replace(cfg, n_layers=1)
    S = tokens.shape[1]
    dev = tokens.device
    x = params["embed"][tokens.long()]
    pos = torch.arange(S, device=dev)[None]
    worst = {key: 0.0 for key in ("h", "conv", "k", "v")}

    def fresh():
        c = decoder.init_cache(one, 1, S + 1, device=dev)["layers"]
        return {key: t[0] for key, t in c.items()}

    ms = []
    for j in range(cfg.n_layers):
        bp = decoder.layer_params(params["blocks"], j)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_next, whole, _ = decoder.run_block(cfg, bp, x, pos, fresh(), 0,
                                             layer_idx=j)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        _, part, _ = decoder.run_block(cfg, bp, x[:, :S - 1], pos[:, :S - 1],
                                       fresh(), 0, layer_idx=j)
        _, part, _ = decoder.run_block(cfg, bp, x[:, S - 1:], pos[:, S - 1:],
                                       part, S - 1, layer_idx=j)
        for key in worst:
            a, b = part[key], whole[key]
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst[key] = max(worst[key], rel)
            require(rel <= 1e-4, f"layer {j} {key}: handoff differs by {rel} "
                    "of its largest entry")
        x = x_next
    emit({"phase": "hybrid_handoff_by_layer", "S": S, "window": cfg.window,
          "state_rel": worst, "tolerance": 1e-4,
          "layer_ms_median": statistics.median(ms)})


# --------------------------------------------------- the vlm and audio archs

def grid_positions3(n_patches, n_text, B):
    """Qwen2-VL's layout as a numpy (3, B, n_patches + n_text) int32 array:
    patch i of a square grid of side s at (t=0, h=i // s, w=i % s), then
    the text at max + 1 onwards on all three streams."""
    import numpy as np

    side = max(1, math.isqrt(n_patches))
    i = np.arange(n_patches)
    grid = np.stack([0 * i, i // side, i % side])
    text = np.arange(n_text) + (grid.max() + 1 if n_patches else 0)
    pos = np.concatenate([grid, np.stack([text] * 3)], axis=1)
    return np.ascontiguousarray(np.broadcast_to(
        pos[:, None], (3, B, n_patches + n_text)).astype(np.int32))


def stub_batch(cfg, n_text, B, seed, grid=True):
    """A served batch of ``cfg``'s arch from a numpy seed: tokens, and for
    vlm ``n_patches`` patch embeddings ~ N(0, 1) (with grid positions, or
    none: ``arange`` on the three streams), for audio frames ~ N(0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_text),
                                    dtype=np.int32)}
    if cfg.arch == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32)
        if grid:
            batch["positions3"] = grid_positions3(cfg.n_patches, n_text, B)
    if cfg.arch == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_source), dtype=np.float32)
    return batch


def timed_generation(torch, eng, feed=None):
    """Wrap ``eng.ops``' prefill and decode step: each call's seconds
    (synchronized on a card), its logits as a host array (``logits``: the
    prefill's, then every step's), and for an encoder-decoder the cache's
    cross K/V as the prefill left it (a copy) beside the last cache.
    ``feed`` (steps, B) replays another run's tokens: step i decodes
    ``feed[i]`` in place of the token the engine chose."""
    ops = eng.ops
    rec = {"prefill_s": [], "decode_s": [], "logits": [], "cache": None,
           "xkv0": None}

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize()

    def prefill(*a):
        sync()
        t0 = time.perf_counter()
        out = ops.prefill(*a)
        sync()
        rec["prefill_s"].append(time.perf_counter() - t0)
        rec["logits"].append(out[0].cpu().numpy())
        rec["cache"] = out[1]
        if "xk" in out[1]["layers"]:
            rec["xkv0"] = tuple(out[1]["layers"][k].clone()
                                for k in ("xk", "xv"))
        return out

    def decode_step(params, cfg, tok, cache):
        if feed is not None:
            tok = torch.as_tensor(feed[len(rec["decode_s"])],
                                  dtype=torch.int32, device=tok.device)
        sync()
        t0 = time.perf_counter()
        out = ops.decode_step(params, cfg, tok, cache)
        sync()
        rec["decode_s"].append(time.perf_counter() - t0)
        rec["logits"].append(out[0].cpu().numpy())
        rec["cache"] = out[1]
        return out

    eng.ops = dataclasses.replace(ops, prefill=prefill,
                                  decode_step=decode_step)
    return rec


def generated_three_ways(torch, cfg, params, batches, steps, device="cuda"):
    """``GenerationEngine`` over each of ``batches`` three times on one
    init: on ``device`` in float32 (card32, greedy), then on the CPU in
    float32 and float64 fed card32's tokens.  Returns each run's launch
    counts and the per-call max|card32 - cpu64| and max|cpu32 - cpu64|
    (each prefill, then each step, batch after batch)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.params import params_from_numpy, params_to_numpy
    from repro_torch.serving import GenerationEngine

    tree = params_to_numpy(params)
    runs = {"card32": (params, device, torch.float32),
            "cpu32": (params_from_numpy(tree, "cpu"), "cpu", torch.float32),
            "cpu64": (params_from_numpy(_cast_tree(tree, np.float64), "cpu"),
                      "cpu", torch.float64)}
    logits, counts, feeds = {}, {}, []
    for name, (p, dev, dtype) in runs.items():
        ops.reset_launch_counts()
        logits[name] = []
        for i, batch in enumerate(batches):
            eng = GenerationEngine(cfg, p, dtype=dtype, device=dev)
            rec = timed_generation(
                torch, eng, None if name == "card32" else feeds[i])
            toks, _ = eng.generate(batch, steps + 1)
            if name == "card32":
                feeds.append(toks.T)
            logits[name].extend(rec["logits"])
        counts[name] = ops.launch_counts()
    require(not any(counts["cpu32"].values())
            and not any(counts["cpu64"].values()),
            f"the CPU runs launched kernels: {counts}")
    require(logits["cpu64"][0].dtype == np.float64, "the fp64 run is not fp64")

    def diffs(a, b):
        return [float(np.abs(x - y).max()) for x, y in zip(a, b)]

    return (logits, counts, diffs(logits["card32"], logits["cpu64"]),
            diffs(logits["cpu32"], logits["cpu64"]))


def vlm_parity_phase(torch, device="cuda", text=None, prompts=None):
    """Gate V1: a reduced qwen2-vl-7b (``VLM_REDUCED``: L=4, d=256, H=4,
    Hk=1, hd=64, M-RoPE sections (8, 12, 12), 16 patches, vocab 512) on
    one init, on ``device`` (the card) in float32 and on the CPU in
    float32 and float64 fed the card's greedy tokens, two routes:
    ``GenerationEngine`` at B=2 over 16 patch embeddings and grid
    positions before ``VLM_SMALL_TEXT`` text tokens (totals 2048 and 116),
    and ``BatchEngine`` per slot over the text prompts
    ``VLM_SMALL_PROMPTS``, ``VLM_SMALL_STEPS`` steps each.  Over every
    prefill's and step's logits: max|card32 - cpu64| <= max(1e-4, 2
    max|cpu32 - cpu64|).  The card launches ``flash_attention`` exactly
    L x (the prefills of >= 2048 tokens) = 4 x 3 times, nothing else; the
    CPU runs launch nothing.  ``device="cpu"`` with short lengths
    rehearses it on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import decoder

    t0 = time.perf_counter()
    cfg = get_config("qwen2-vl-7b").reduced(**VLM_REDUCED)
    L = cfg.n_layers
    text = VLM_SMALL_TEXT if text is None else text
    lengths = VLM_SMALL_PROMPTS if prompts is None else prompts
    params = decoder.init_params(
        cfg, torch.Generator(device=device).manual_seed(9), device)
    batches = [stub_batch(cfg, n, 2, 90 + n) for n in text]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
               for n in lengths]
    gen = generated_three_ways(torch, cfg, params, batches, VLM_SMALL_STEPS,
                               device)
    slot = served_three_ways(torch, cfg, 9, prompts, VLM_SMALL_STEPS, device,
                             params=params)
    n_long = (sum(n + cfg.n_patches >= 2048 for n in text)
              + sum(n >= 2048 for n in lengths))
    want = {k: 0 for k in kops.launch_counts()}
    if device == "cuda":
        want["flash_attention"] = L * n_long
        require(n_long == 3, f"{n_long} long prefills")
    counts = {k: gen[1]["card32"][k] + slot[1]["card32"][k] for k in want}
    card, cpu = gen[2] + slot[2], gen[3] + slot[3]
    limit = max(1e-4, 2 * max(cpu))
    line = {"phase": "vlm_parity", "config": f"qwen2-vl-7b reduced(L={L}, "
            f"d={cfg.d_model}, H={cfg.n_heads}, Hk={cfg.n_kv_heads}, "
            f"hd={cfg.hd}, sections={list(cfg.mrope_sections)}, n_patches="
            f"{cfg.n_patches}, vocab={cfg.vocab})", "device": device,
            "generation_text": list(text), "slot_prompts": list(lengths),
            "decode_steps": VLM_SMALL_STEPS, "launches_card32": counts,
            "max_abs_logit_err": {"card32_vs_cpu64": max(card),
                                  "cpu32_vs_cpu64": max(cpu)},
            "v1_limit": limit,
            "generation_card32_vs_cpu64": max(gen[2]),
            "slot_card32_vs_cpu64": max(slot[2]),
            "seconds": time.perf_counter() - t0}
    emit(line)
    require(counts == want, f"card launches {counts}, want {want}")
    require(max(card) <= limit, f"gate V1 fails: card32 vs cpu64 {max(card)} "
            f"> {limit}")
    return line


def audio_parity_phase(torch, device="cuda", prompts=None):
    """Gate A1: a reduced whisper-small (L=2, enc_layers 2, enc_seq 64,
    d=256, H=Hk=4, hd=64, vocab 512) through ``GenerationEngine`` at B=2,
    prompts ``AUDIO_SMALL_PROMPTS`` (2048 and 37), ``AUDIO_SMALL_STEPS``
    steps each, on one init on ``device`` in float32 and on the CPU in
    float32 and float64 fed the card's tokens: V1's bound, and
    ``flash_attention`` launched exactly L x 1 times on the card (the
    2048-token prompt's decoder self-attention; the encoder and the
    cross-attention launch nothing), never on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import encdec

    t0 = time.perf_counter()
    cfg = get_config("whisper-small").reduced()
    L = cfg.n_layers
    lengths = AUDIO_SMALL_PROMPTS if prompts is None else prompts
    params = encdec.init_params(
        cfg, torch.Generator(device=device).manual_seed(11), device)
    batches = [stub_batch(cfg, n, 2, 110 + n) for n in lengths]
    _, counts, card, cpu = generated_three_ways(
        torch, cfg, params, batches, AUDIO_SMALL_STEPS, device)
    want = {k: 0 for k in kops.launch_counts()}
    if device == "cuda":
        want["flash_attention"] = L * sum(n >= 2048 for n in lengths)
        require(want["flash_attention"] == L, f"launches {want}")
    limit = max(1e-4, 2 * max(cpu))
    line = {"phase": "audio_parity", "config": f"whisper-small reduced(L={L}"
            f", enc_layers={cfg.enc_layers}, enc_seq={cfg.enc_seq}, d="
            f"{cfg.d_model}, H={cfg.n_heads}, hd={cfg.hd}, vocab={cfg.vocab})",
            "device": device, "prompts": list(lengths), "batch": 2,
            "decode_steps": AUDIO_SMALL_STEPS,
            "launches_card32": counts["card32"],
            "max_abs_logit_err": {"card32_vs_cpu64": max(card),
                                  "cpu32_vs_cpu64": max(cpu)},
            "a1_limit": limit, "card32_vs_cpu64_per_call": card,
            "cpu32_vs_cpu64_per_call": cpu,
            "seconds": time.perf_counter() - t0}
    emit(line)
    require(counts["card32"] == want, f"card launches {counts['card32']}, "
            f"want {want}")
    require(max(card) <= limit, f"gate A1 fails: card32 vs cpu64 {max(card)} "
            f"> {limit}")
    return line


def handoff_by_layer_kv(torch, phase, x, pos, layers, tol=1e-4):
    """Gates V3's and A3's handoff, layer by layer: each layer, fed the
    input that prefill(S) gives it, runs prefill(S) and prefill(S - 1) +
    one decode step from a fresh cache; its k and v (every slot of the
    cache) lie within ``tol`` of their largest entry.  ``layers`` holds a
    (run, fresh) pair per layer: ``run(x, pos, cache, cache_len) -> (x,
    cache)``, ``fresh() -> cache`` of S + 1 slots."""
    S = x.shape[1]
    worst = {"k": 0.0, "v": 0.0}
    ms = []
    for j, (run, fresh) in enumerate(layers):
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_next, whole = run(x, pos, fresh(), 0)
        if x.is_cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        _, part = run(x[:, :S - 1], pos[..., :S - 1], fresh(), 0)
        _, part = run(x[:, S - 1:], pos[..., S - 1:], part, S - 1)
        for key in worst:
            a, b = part[key], whole[key]
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst[key] = max(worst[key], rel)
            require(rel <= tol, f"{phase} layer {j} {key}: handoff differs "
                    f"by {rel} of its largest entry")
        x = x_next
    emit({"phase": f"{phase}_by_layer", "S": S, "kv_rel": worst,
          "tolerance": tol, "layer_ms_median": statistics.median(ms)})


def handoff_end_to_end(torch, cfg, params, batch, phase="xlstm_handoff",
                       moved_keys=(), ref64=False):
    """Gates G3's, Y3's, V3's and A3's end-to-end handoff on the same
    model: prefill(batch) (route a) against prefill(batch less its last
    token) + one decode step of that token (route b).  G3's form: |b - a|
    is no larger than what a one-ulp move of every input embedding entry
    (the token embeddings, and ``moved_keys`` of the batch) does to a's
    logits in the same run.  With
    ``ref64`` (A3's form) that ratio is reported and the gate is instead
    held against both routes in float64 on a float64 copy of the weights:
    |a64 - b64| <= 1e-10 max|a64| (one function), and |b - b64| <= 2
    |a - a64| + 1e-6 max|a64| (the handoff route's fp32 error at most
    twice the prefill's, G1's form).  A wrong handoff must then fail that
    limit: route b again with the cached self-attention k and v rounded
    to bf16 before the step (a cache kept in bf16)."""
    from repro_torch.models import ops_for
    from repro_torch.tree import tree_map

    ops = ops_for(cfg)
    tokens = batch["tokens"]
    dev = tokens.device
    n = tokens.shape[1] + (batch["vision_embeds"].shape[1]
                           if "vision_embeds" in batch else 0)
    inf = torch.tensor(float("inf"), device=dev)

    def prefill(p, b, dtype=torch.float32):
        cache = ops.init_cache(cfg, tokens.shape[0], n + 1, dtype, device=dev)
        return ops.prefill(p, cfg, b, cache)

    def handoff_route(p, dtype=torch.float32, fault=lambda cache: cache):
        _, cache = prefill(p, dict(batch, tokens=tokens[:, :-1]), dtype)
        return ops.decode_step(p, cfg, tokens[:, -1], fault(cache))[0]

    def routes(p, dtype=torch.float32):
        return prefill(p, batch, dtype)[0], handoff_route(p, dtype)

    whole, step = routes(params)
    moved = dict(params, embed=torch.nextafter(params["embed"], inf))
    ulp, _ = prefill(moved, {k: torch.nextafter(v, inf) if k in moved_keys
                             else v for k, v in batch.items()})
    del moved
    handoff = (step - whole).abs().max().item()
    ulp_change = (ulp - whole).abs().max().item()
    line = {"phase": phase, "S": n, "handoff_max_abs_logit_diff": handoff,
            "one_ulp_embedding_max_abs_logit_change": ulp_change,
            "handoff_over_one_ulp": handoff / ulp_change,
            "logit_std": whole.std().item()}
    require(bool(torch.isfinite(step).all() and torch.isfinite(whole).all()),
            "non-finite handoff logits")
    if not ref64:
        emit(line)
        require(handoff <= ulp_change, f"{phase}: {n - 1} + 1 vs {n} logits "
                f"differ by {handoff}, more than one ulp of the embeddings "
                f"moves them ({ulp_change})")
        return
    p64 = tree_map(lambda t: t.double(), params)
    whole64, step64 = routes(p64, torch.float64)
    del p64
    top = whole64.abs().max().item()
    line.update({
        "route64_max_abs_diff": (whole64 - step64).abs().max().item(),
        "prefill32_vs_64": (whole.double() - whole64).abs().max().item(),
        "handoff32_vs_64": (step.double() - step64).abs().max().item(),
        "max_abs_logit64": top})
    line["a3_limit"] = 2 * line["prefill32_vs_64"] + 1e-6 * top

    def bf16_kv(cache):
        layers = dict(cache["layers"])
        for k in ("k", "v"):
            layers[k] = layers[k].bfloat16().to(layers[k].dtype)
        return dict(cache, layers=layers)

    wrong = handoff_route(params, fault=bf16_kv)
    line["bf16_kv_handoff32_vs_64"] = (wrong.double()
                                       - step64).abs().max().item()
    emit(line)
    require(line["bf16_kv_handoff32_vs_64"] > line["a3_limit"],
            f"{phase}: a handoff through a bf16 cache reads "
            f"{line['bf16_kv_handoff32_vs_64']}, within the limit")
    require(line["route64_max_abs_diff"] <= 1e-10 * top,
            f"{phase}: in float64 the two routes differ by "
            f"{line['route64_max_abs_diff']}")
    require(line["handoff32_vs_64"] <= line["a3_limit"],
            f"{phase}: the handoff route's fp32 error "
            f"{line['handoff32_vs_64']} > {line['a3_limit']}")


def profile_generation(torch, eng, batch, steps: int = 2):
    """A ``GenerationEngine`` decode step's device busy and idle share:
    prefill, one warm step, then ``steps`` steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    cfg = eng.cfg
    toks = {k: torch.as_tensor(v, device=eng.device) for k, v in batch.items()}
    B, S = toks["tokens"].shape
    extra = cfg.n_patches if cfg.arch == "vlm" else 0
    cache = eng.ops.init_cache(cfg, B, S + extra + steps + 2, device=eng.device)
    with torch.no_grad():
        logits, cache = eng.ops.prefill(eng.params, cfg, toks, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = eng.ops.decode_step(eng.params, cfg, tok, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32)
                logits, cache = eng.ops.decode_step(eng.params, cfg, tok,
                                                    cache)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    del cache
    emit({"phase": "decode_profile", "model": cfg.name,
          "engine": "GenerationEngine", "batch": B, "steps": steps,
          **device_time(prof, wall_us, steps)})


def serving_vlm_phase(torch, device="cuda", cfg=None, text=VLM_TEXT,
                      prompts=VLM_PROMPTS, cli_prompt=2048):
    """Gates V2 and V3: qwen2-vl-7b at full width and depth in fp32.
    ``GenerationEngine`` at B=2 over 256 patch embeddings and grid
    positions before ``VLM_TEXT`` text tokens, ``VLM_STEPS`` greedy steps;
    then text per slot through ``BatchEngine`` (4 sessions, page 32,
    ``VLM_PROMPTS``, ``VLM_STEPS`` steps): finite logits of the vocab's
    width; ``flash_attention`` launched exactly 28 x (the prefills of >=
    2048 tokens) and nothing else; 0 pages after close; each session's
    cache ``VLM_KV_BYTES_PER_TOKEN`` a token of its capacity.  Then V3's
    handoff on the first slot prompt with 256 patches (broadcast
    positions: prefill(2303) + one step against prefill(2304)), a profile
    of 2 steps of each engine, and, the model freed, ``launch.serve.main``
    (a 2048-token prompt, 8 tokens).  ``device="cpu"`` with a reduced ``cfg``
    and short lengths rehearses it (no launches, no profile)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import decoder
    from repro_torch.serving import BatchEngine, GenerationEngine, ShardModule
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    full = cfg is None
    cfg = get_config("qwen2-vl-7b") if full else cfg
    L, on_card = cfg.n_layers, device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = decoder.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    require(n_params == cfg.param_count() + 2 * L * cfg.d_model,
            f"{n_params} parameters in the tree")
    per_token = L * 2 * cfg.n_kv_heads * cfg.hd * 4
    if full:
        require(per_token == VLM_KV_BYTES_PER_TOKEN, f"{per_token} B a token")

    def want(n_long):
        w = {k: 0 for k in ops.launch_counts()}
        if on_card:
            w["flash_attention"] = L * n_long
        return w

    # GenerationEngine: patches, grid positions, the text
    batch = stub_batch(cfg, text, 2, 0)
    eng = GenerationEngine(cfg, params, device=device)
    rec = timed_generation(torch, eng)
    ops.reset_launch_counts()
    toks, _ = eng.generate(batch, VLM_STEPS + 1)
    gen_counts = ops.launch_counts()
    gen_logits = rec["logits"]
    del eng
    gen = {"batch": 2, "n_patches": cfg.n_patches, "text": text,
           "prefill_ms": rec["prefill_s"][0] * 1e3,
           "decode_ms_per_step_median":
               statistics.median(rec["decode_s"]) * 1e3,
           "tokens_per_s": 2 * VLM_STEPS / sum(rec["decode_s"]),
           "launches": gen_counts, "first_tokens": toks[:, :4].tolist()}
    del rec

    # BatchEngine per slot: text only
    rng = np.random.default_rng(0)
    slot_prompts = [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
                    for n in prompts]
    module = ShardModule(cfg, params, (0, L), is_first=True, is_last=True)
    sim = Sim(seed=0)
    beng = BatchEngine(module, sim, n_slots=4, page_size=32, device=device)
    require(not beng.fused, "qwen2-vl must serve per slot")
    ops.reset_launch_counts()
    first, prefill_s, logits, step_s, feed, held = _drive(
        beng, sim, slot_prompts, VLM_STEPS)
    slot_counts = ops.launch_counts()
    pages_after = beng.stats["pages"]
    del beng, sim             # the Sim's leak gauge holds the engine
    peak = torch.cuda.max_memory_allocated() if on_card else None
    capacity = [32 * -(-(n + VLM_STEPS) // 32) for n in prompts]
    line = {"phase": "serving_vlm", "model": cfg.name, "n_layers": L,
            "d_model": cfg.d_model, "params": n_params, "init_s": init_s,
            "generation": gen,
            "slot": {"prompts": list(prompts),
                     "prefill_ms": [t * 1e3 for t in prefill_s],
                     "decode_steps": VLM_STEPS,
                     "decode_ms_per_step_median":
                         statistics.median(step_s) * 1e3,
                     "tokens_per_s": len(prompts) * VLM_STEPS / sum(step_s),
                     "launches": slot_counts,
                     "pages_after_close": pages_after,
                     "cache_bytes_per_session": held,
                     "kv_bytes_per_token": per_token},
            "max_memory_allocated_bytes": peak}
    emit(line)
    for out in gen_logits + [first] + logits:
        require(out.shape[1] == cfg.vocab, f"shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite logits")
    require(gen_counts == want(int(text + cfg.n_patches >= 2048)),
            f"qwen2-vl generation launches {gen_counts}")
    require(slot_counts == want(sum(n >= 2048 for n in prompts)),
            f"qwen2-vl per-slot launches {slot_counts}")
    require(pages_after == 0, f"pages after close: {pages_after}")
    require(held == [per_token * c for c in capacity],
            f"cache bytes {held}, want {per_token} B x {capacity}")
    del gen_logits, first, logits

    # V3: prefill(S - 1) + one step against prefill(S), S = patches + text
    t0 = time.perf_counter()
    hand = stub_batch(cfg, prompts[0], 1, 1, grid=False)
    hand["tokens"] = slot_prompts[0]
    hand = {k: torch.from_numpy(v).to(device) for k, v in hand.items()}
    x = torch.cat([hand["vision_embeds"], params["embed"][
        hand["tokens"].long()]], dim=1)
    S = x.shape[1]
    pos = torch.arange(S, device=device, dtype=torch.int32)[None, None].expand(
        3, 1, S)
    kv_shape = (1, S + 1, cfg.n_kv_heads, cfg.hd)

    def layer(j):
        bp = decoder.layer_params(params["blocks"], j)

        def run(x, pos, cache, cache_len):
            y, c, _ = decoder.run_block(cfg, bp, x, pos, cache, cache_len,
                                        layer_idx=j)
            return y, c

        def fresh():
            return {k: torch.zeros(kv_shape, device=device)
                    for k in ("k", "v")}
        return run, fresh

    with torch.no_grad():
        handoff_by_layer_kv(torch, "vlm_handoff", x, pos,
                            [layer(j) for j in range(L)])
        del x
        handoff_end_to_end(torch, cfg, params, hand, "vlm_handoff",
                           moved_keys=("vision_embeds",))
    handoff_s = time.perf_counter() - t0
    if on_card:
        profile_decode(torch, module, slot_prompts, feed, steps=2)
        eng = GenerationEngine(cfg, params, device=device)
        profile_generation(torch, eng, stub_batch(cfg, text, 2, 0))
        del eng
    del module, params, hand
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the launcher, once, on the same device, after the model is freed
    t0 = time.perf_counter()
    argv = ["--arch", "qwen2-vl-7b", "--prompt-len", str(cli_prompt), "--gen",
            "8", "--batch", "1", "--device", device]
    serve_vocab = cfg.vocab
    if not full:
        argv.append("--reduced")
        serve_vocab = get_config("qwen2-vl-7b").reduced().vocab
    cli = serve.main(argv)
    serve_s = time.perf_counter() - t0
    require(cli.shape == (1, 8) and bool((cli >= 0).all())
            and bool((cli < serve_vocab).all()), f"launch.serve gave {cli}")
    emit({"phase": "serving_vlm_done", "serve_cli_s": serve_s,
          "handoff_s": handoff_s,
          "max_memory_allocated_bytes":
              torch.cuda.max_memory_allocated() if on_card else None,
          "seconds": time.perf_counter() - t_phase})
    return line


def serving_audio_phase(torch, device="cuda", cfg=None,
                        prompts=AUDIO_PROMPTS, cli_prompt=448):
    """Gates A2 and A3: whisper-small at full width and depth in fp32
    (enc_seq 1500).  ``GenerationEngine`` at B=4 over frames ~ N(0, 1)
    and a prompt of each length of ``AUDIO_PROMPTS`` (448, 2048),
    ``AUDIO_STEPS`` greedy steps each: finite logits of the vocab's
    width; ``flash_attention`` launched exactly 12 times for the 2048
    prompt and never for 448, nothing else; the encoder runs once per
    generation; the cross K/V, ``AUDIO_CROSS_BYTES`` a session, is
    ``torch.equal`` after the last step to what the prefill wrote.  Then
    A3's handoff (prefill(447) + one step against prefill(448)), a
    profile of 2 decode steps, and ``launch.serve.main`` (a 448-token
    prompt, 8 tokens).  ``device="cpu"`` with a reduced ``cfg`` and short
    prompts rehearses it."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.serving import GenerationEngine
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    full = cfg is None
    cfg = get_config("whisper-small") if full else cfg
    L, on_card = cfg.n_layers, device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = encdec.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    cross = L * 2 * cfg.enc_seq * cfg.n_kv_heads * cfg.hd * 4
    if full:
        require(cross == AUDIO_CROSS_BYTES, f"{cross} B of cross K/V")

    runs = []
    real_encode = encdec.encode
    encodes = []

    def counting_encode(*a):
        encodes.append(1)
        return real_encode(*a)

    encdec.encode = counting_encode
    try:
        for n in prompts:
            batch = stub_batch(cfg, n, AUDIO_BATCH, n)
            eng = GenerationEngine(cfg, params, device=device)
            rec = timed_generation(torch, eng)
            encodes.clear()
            ops.reset_launch_counts()
            toks, _ = eng.generate(batch, AUDIO_STEPS + 1)
            counts = ops.launch_counts()
            layers = rec["cache"]["layers"]
            held = sum(layers[k].numel() * layers[k].element_size()
                       for k in ("xk", "xv")) // AUDIO_BATCH
            kept = all(torch.equal(layers[k], x0)
                       for k, x0 in zip(("xk", "xv"), rec["xkv0"]))
            want = {k: 0 for k in counts}
            if on_card:
                want["flash_attention"] = L * (n >= 2048)
            runs.append({"prompt": n, "batch": AUDIO_BATCH,
                         "prefill_ms": rec["prefill_s"][0] * 1e3,
                         "decode_steps": len(rec["decode_s"]),
                         "decode_ms_per_step_median":
                             statistics.median(rec["decode_s"]) * 1e3,
                         "tokens_per_s": AUDIO_BATCH * len(rec["decode_s"])
                         / sum(rec["decode_s"]),
                         "launches": counts, "encoder_runs": len(encodes),
                         "cross_kv_bytes_per_session": held,
                         "cross_kv_unchanged": kept})
            for out in rec["logits"]:
                require(out.shape == (AUDIO_BATCH, cfg.vocab)
                        and bool(np.isfinite(out).all()),
                        f"whisper logits {out.shape} not finite")
            require(counts == want, f"whisper launches {counts} != {want}")
            require(len(encodes) == 1, f"the encoder ran {len(encodes)} times")
            require(held == cross, f"{held} B of cross K/V a session")
            require(kept, "decode changed the cross K/V")
            del eng, rec, layers
    finally:
        encdec.encode = real_encode
    peak = torch.cuda.max_memory_allocated() if on_card else None
    line = {"phase": "serving_audio", "model": cfg.name, "n_layers": L,
            "enc_layers": cfg.enc_layers, "enc_seq": cfg.enc_seq,
            "d_model": cfg.d_model, "params": n_params, "init_s": init_s,
            "runs": runs, "max_memory_allocated_bytes": peak}
    emit(line)

    # A3: prefill(447) + one step against prefill(448)
    t0 = time.perf_counter()
    hand = stub_batch(cfg, prompts[0], 1, 3)
    hand = {k: torch.from_numpy(v).to(device) for k, v in hand.items()}
    with torch.no_grad():
        enc_out = encdec.encode(params, cfg, hand["frames"])
        x = params["embed"][hand["tokens"].long()]
        S = x.shape[1]
        pos = torch.arange(S, device=device, dtype=torch.int32)[None]
        kv_shape = (1, S + 1, cfg.n_kv_heads, cfg.hd)

        def layer(j):
            bp = encdec.layer_params(params["dec_blocks"], j)
            xk, xv = encdec.cross_kv(bp["xattn"], cfg, enc_out)

            def run(x, pos, cache, cache_len):
                return encdec.run_dec_block(cfg, bp, x, pos, cache, cache_len)

            def fresh():
                return {"k": torch.zeros(kv_shape, device=device),
                        "v": torch.zeros(kv_shape, device=device),
                        "xk": xk, "xv": xv}
            return run, fresh

        handoff_by_layer_kv(torch, "audio_handoff", x, pos,
                            [layer(j) for j in range(L)])
        del x, enc_out
        handoff_end_to_end(torch, cfg, params, hand, "audio_handoff",
                           moved_keys=("frames",), ref64=True)
    handoff_s = time.perf_counter() - t0
    if on_card:
        eng = GenerationEngine(cfg, params, device=device)
        profile_generation(torch, eng, stub_batch(cfg, prompts[0],
                                                  AUDIO_BATCH, 4))
        del eng

    t0 = time.perf_counter()
    argv = ["--arch", "whisper-small", "--prompt-len", str(cli_prompt),
            "--gen", "8", "--batch", "1", "--device", device]
    serve_vocab = cfg.vocab
    if not full:
        argv.append("--reduced")
        serve_vocab = get_config("whisper-small").reduced().vocab
    cli = serve.main(argv)
    serve_s = time.perf_counter() - t0
    require(cli.shape == (1, 8) and bool((cli >= 0).all())
            and bool((cli < serve_vocab).all()), f"launch.serve gave {cli}")
    emit({"phase": "serving_audio_done", "serve_cli_s": serve_s,
          "handoff_s": handoff_s, "seconds": time.perf_counter() - t_phase})
    return line


TRAIN_STEPS = 4


def named_leaves(tree, prefix="", sep="."):
    """(path, leaf) of a nested dict of tensors, keys joined by ``sep``; a
    list (the xLSTM stack) is keyed by its indices."""
    for k, v in (sorted(tree.items()) if isinstance(tree, dict)
                 else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from named_leaves(v, f"{prefix}{k}{sep}", sep)
        else:
            yield f"{prefix}{k}", v


def timed_steps(torch, cfg, state, data, device="cuda", n=2):
    """``n`` more steps at lr 3e-3 on ``data``'s next batches, each timed
    on the host clock in its forward, backward (``torch.autograd.grad``)
    and optimizer (clip, then AdamW) parts, synchronised at each boundary.
    Returns (state, timings)."""
    from repro_torch.models import ops_for
    from repro_torch.optim import adamw_update, clip_by_global_norm
    from repro_torch.tree import leaves

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    model = ops_for(cfg)
    timings = []
    for _ in range(n):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        sync()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(state.params, cfg, batch)
        sync()
        t1 = time.perf_counter()
        g = torch.autograd.grad(loss, leaves(state.params), allow_unused=True,
                                materialize_grads=True)
        sync()
        t2 = time.perf_counter()
        g, _ = clip_by_global_norm(list(g), 1.0)
        state = state._replace(opt=adamw_update(
            state.params, g, state.opt, 3e-3))
        sync()
        t3 = time.perf_counter()
        del g, loss
        timings.append({"forward_ms": (t1 - t0) * 1e3,
                        "backward_ms": (t2 - t1) * 1e3,
                        "optimizer_ms": (t3 - t2) * 1e3,
                        "step_ms": (t3 - t0) * 1e3,
                        "tokens_per_s": batch["tokens"].numel() / (t3 - t0)})
    return state, timings


def training_phase(torch):
    """Gate T3: minicpm-2b at full width and depth in fp32, B=1, S=2048,
    ``TRAIN_STEPS`` steps through the user's entry point
    ``launch.train.main``: every loss and grad norm finite, and the flash
    forward and backward kernels launched once per layer per step, nothing
    else.  Then, from a fresh state, one step through ``make_train_step``'s
    own gradient pass: every gradient leaf finite and not all zero, and
    wq, wk, wv nonzero in every layer; and two more steps timed in their
    forward, backward and optimizer parts."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import cosine_schedule
    from repro_torch.tree import leaves
    from repro_torch.train import make_train_step, train_state_init

    cfg = get_config("minicpm-2b")
    L, B, S = cfg.n_layers, 1, 2048
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = launch_train.main(["--arch", "minicpm-2b", "--steps",
                              str(TRAIN_STEPS), "--batch", str(B), "--seq",
                              str(S)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want["flash_attention"] = want["flash_attention_bwd"] = L * TRAIN_STEPS
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    require(len(hist) == TRAIN_STEPS, f"{len(hist)} steps recorded")
    require(all(math.isfinite(x) for x in losses + norms),
            f"T3: non-finite loss or grad norm {losses} {norms}")
    require(counts == want, f"T3 launches {counts} != {want}")
    release(torch, "the extra training step")

    gen = torch.Generator(device="cuda").manual_seed(1)
    state = train_state_init(cfg, gen, "cuda")
    n_params = sum(p.numel() for p in leaves(state.params))
    step = make_train_step(cfg, cosine_schedule(3e-3, 0, TRAIN_STEPS))
    data = make_batch_iterator(cfg.vocab, S, B, seed=1)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(data).items()}
    _, _, grads = step.grads_of(state.params, batch)
    bad = {}
    for name, g in named_leaves(grads):
        # a layer-stacked leaf must be nonzero in every layer
        alive = (g.flatten(1).ne(0).any(1) if name.startswith("blocks.")
                 else g.ne(0).any()[None])
        finite = bool(torch.isfinite(g).all())
        if not finite or not bool(alive.all()):
            bad[name] = {"finite": finite,
                         "zero_layers": (~alive).nonzero().flatten().tolist()}
    del grads
    require(not bad, f"T3: gradient leaves not finite or all zero: {bad}")

    state, timings = timed_steps(torch, cfg, state, data)
    emit({"phase": "training", "model": cfg.name, "n_layers": L,
          "d_model": cfg.d_model, "params": n_params, "batch": B, "seq": S,
          "steps": TRAIN_STEPS, "loss": losses, "grad_norm": norms,
          "launches": counts, "main_wall_s": wall_s,
          "main_tokens_per_s": TRAIN_STEPS * B * S / wall_s,
          "max_memory_allocated_bytes": peak,
          "timed_steps": timings})
    del state
    return counts, timings[-1]


#: T3h, T3v, T3a, T3x: arch -> (gate, batch, text tokens, layers kept or
#: None for full depth, parameters in the tree, predicted peak bytes, the
#: peak lr of the cosine schedule).
#: qwen2-vl keeps 4 of its 28 layers (7,615,487,488 less 24 x 233,053,184
#: parameters; all 28 with AdamW would need 122 GB); its text follows 256
#: patches (S=2304).  xlstm-1.3b keeps 8 of its 48 layers, 7 mLSTM and
#: its first sLSTM (layer 7): 2 x 50304 x 2048 + 2048 for the embedding,
#: the head and the final norm, and 8 x 113,232,704 for the layers, each
#: holding both an mLSTM and an sLSTM tree (all 48 with AdamW would need
#: 90 GB).  The peaks: parameters, gradients and two AdamW moments at 16
#: B a parameter, plus the activations the backward keeps and the logits
#: (``scripts/hymba_block_saved_bytes.py`` for hymba's).  The lr is the
#: launcher's 3e-3 but for xlstm-1.3b, whose fp32 run from random weights
#: leaves the finite numbers at it (NaN gradients at step 3 in its mLSTM
#: gates, on the card and in the plain scan on the CPU, where float64
#: stays finite; ``scripts/xlstm_lr_probe.py``); at 3e-4 fp32 keeps to
#: float64's path.
T3_ARCHS = {"hymba-1.5b": ("T3h", 1, 4096, None, 1_644_856_000, 66e9, 3e-3),
            "qwen2-vl-7b": ("T3v", 1, 2048, 4, 2_022_211_072, 41e9, 3e-3),
            "whisper-small": ("T3a", 2, 2048, None, 335_106_048, 24e9, 3e-3),
            "xlstm-1.3b": ("T3x", 1, 2048, 8, 1_112_279_104, 23e9, 3e-4)}
#: the layer-stacked subtrees of a decoder and an encoder-decoder
STACKED = ("blocks.", "enc_blocks.", "dec_blocks.")


def arch_training_phase(torch, arch, device="cuda", cfg=None, n_text=None):
    """Gates T3h, T3v, T3a, T3x: ``arch`` at full width (qwen2-vl cut to 4
    layers, xlstm-1.3b to 8), fp32, ``TRAIN_STEPS`` steps with
    ``launch.train``'s cosine schedule at the lr of ``T3_ARCHS`` (3e-3,
    xlstm-1.3b 3e-4): hymba-1.5b (B=1, S=4096) and
    xlstm-1.3b (B=1, S=2048; the registry's config cut by ``cut_depth``)
    through ``launch.train.main``, on text batches, as JAX's launcher
    draws; qwen2-vl-7b (B=1, 256 patches on a 16 x 16 grid + 2048 text
    tokens) and whisper-small (B=2, frames of (2, 1500, 768), S=2048)
    through the port's ``Trainer`` over ``train_batches``.  Every loss
    and grad norm finite; the flash forward and backward launched once
    per (decoder) layer per step, L x 4 each (xLSTM: the mLSTM kernel
    once per mLSTM layer per step, 7 x 4), nothing else (whisper's
    encoder and cross-attention launch none).  Then one more gradient
    pass: the tree holds the parameters the arch's line of ``T3_ARCHS``
    says; every gradient leaf finite and not all zero, and every
    layer-stacked leaf (the Mamba branch's ``A_log``, ``dt_bias``,
    ``D_skip`` and ``conv_w``, whisper's encoder) nonzero in every layer;
    for xLSTM (``xlstm_dead_leaves``) every leaf of the branch a layer
    runs, and its ``ln1``, not all zero, every leaf of the branch it does
    not run exactly zero.  Then one more step timed in its forward,
    backward and optimizer parts.  The peak is printed beside its
    prediction.  ``device`` and a reduced ``cfg`` (with a short
    ``n_text``) rehearse it on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import make_schedule
    from repro_torch.train import Trainer, make_train_step, train_state_init
    from repro_torch.tree import leaves

    gate, B, text, layers, n_want, peak_want, lr = T3_ARCHS[arch]
    full = get_config(arch)
    cfg = cfg or (dataclasses.replace(full, n_layers=layers) if layers
                  else full)
    L = cfg.n_layers
    n_text = text if n_text is None else n_text
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if cfg.arch in ("hybrid", "ssm"):
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
                str(B), "--seq", str(n_text), "--lr", str(lr)]
        if not on_card:
            argv += ["--reduced", "--device", device, "--layers", str(L),
                     "--d-model", str(cfg.d_model), "--vocab",
                     str(cfg.vocab)]
        with (cut_depth(arch, L) if on_card and layers
              else contextlib.nullcontext()):
            hist = launch_train.main(argv)
        state = None
    else:
        gen = torch.Generator(device=device).manual_seed(34)
        trainer = Trainer(cfg, train_state_init(cfg, gen, device),
                          make_schedule("cosine", lr, TRAIN_STEPS),
                          train_batches(cfg, n_text, B, seed=34))
        hist = trainer.run(TRAIN_STEPS, log=None)
        state = trainer.state
        del trainer
    sync()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    want = {k: 0 for k in counts}
    if on_card:
        want.update(train_launches(cfg, TRAIN_STEPS))
    series = {k: [h[k] for h in hist] for k in ("loss", "grad_norm")}
    require(len(hist) == TRAIN_STEPS, f"{gate}: {len(hist)} steps recorded")
    require(all(math.isfinite(x) for v in series.values() for x in v),
            f"{gate}: non-finite loss or grad norm {series}")
    require(counts == want, f"{gate} launches {counts} != {want}")

    if state is None:
        # launch.train's trainer is gone: a fresh state for the pass
        if on_card:
            release(torch, f"{gate}'s gradient pass")
        state = train_state_init(
            cfg, torch.Generator(device=device).manual_seed(1), device)
    n_params = sum(p.numel() for p in leaves(state.params))
    require(not on_card or n_params == n_want,
            f"{gate}: {n_params} parameters, want {n_want}")
    data = train_batches(cfg, n_text, B, seed=1)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in next(data).items()}
    step = make_train_step(cfg, make_schedule("cosine", lr, TRAIN_STEPS))
    _, _, grads = step.grads_of(state.params, batch)
    del batch
    bad = xlstm_dead_leaves(torch, cfg, grads) if cfg.arch == "ssm" else {}
    for name, g in ([] if cfg.arch == "ssm" else named_leaves(grads)):
        # a layer-stacked leaf must be nonzero in every layer
        alive = (g.flatten(1).ne(0).any(1) if name.startswith(STACKED)
                 else g.ne(0).any()[None])
        finite = bool(torch.isfinite(g).all())
        if not finite or not bool(alive.all()):
            bad[name] = {"finite": finite,
                         "zero_layers": (~alive).nonzero().flatten().tolist()}
    del grads
    require(not bad, f"{gate}: gradient leaves not finite or zero in a "
            f"layer: {bad}")

    # one timed step: hymba's takes 8-13 s, most of it host launches
    state, timings = timed_steps(torch, cfg, state, data, device, n=1)
    seq = n_text + (cfg.n_patches if cfg.arch == "vlm" else 0)
    layers_ms = (xlstm_layer_ms(torch, cfg, state.params, B, n_text, device)
                 if cfg.arch == "ssm" else None)
    emit({"phase": f"{cfg.arch}_training", "gate": gate, "model": cfg.name,
          "reduced": ({"n_layers": [full.n_layers, L]}
                      if L != full.n_layers else None),
          "d_model": cfg.d_model, "params": n_params, "batch": B, "seq": seq,
          "steps": TRAIN_STEPS, "lr": lr, **series, "launches": counts,
          "main_wall_s": wall_s,
          "main_tokens_per_s": TRAIN_STEPS * B * seq / wall_s,
          "max_memory_allocated_bytes": peak,
          "max_memory_allocated_bytes_predicted": peak_want if on_card
          else None, "timed_steps": timings, "layer_ms": layers_ms,
          "nvidia_smi": nvidia_smi() if on_card else None})
    del state
    return counts, timings[-1]


def xlstm_layer_ms(torch, cfg, params, B, S, device="cuda"):
    """The forward and backward ms of one mLSTM block (layer 0) and one
    sLSTM block (the first), alone, at the step's (B, S), on a N(0, 1)
    input, each under grad then ``torch.autograd.grad`` of its sum over
    the input and its leaves, synchronised at each boundary (host clock;
    the second of two runs)."""
    from repro_torch.models import decoder
    from repro_torch.tree import leaves

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    g = torch.Generator(device=device).manual_seed(36)
    out = {}
    for name in ("mlstm", "slstm"):
        i = next(j for j in range(cfg.n_layers)
                 if decoder._is_slstm(cfg, j) == (name == "slstm"))
        blk = params["blocks"][i]
        x = torch.randn((B, S, cfg.d_model), generator=g,
                        device=device).requires_grad_(True)
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            y, _ = decoder._run_ssm_block(cfg, blk, x, None, i)
            sync()
            t1 = time.perf_counter()
            torch.autograd.grad(y.sum(), [x] + leaves(blk),
                                allow_unused=True)
            sync()
            t2 = time.perf_counter()
        out[name] = {"layer": i, "forward_ms": (t1 - t0) * 1e3,
                     "backward_ms": (t2 - t1) * 1e3}
        del x, y
    return out


def xlstm_dead_leaves(torch, cfg, grads):
    """T3x's gradient check on an xLSTM gradient tree: {leaf name: what is
    wrong} for every leaf not finite, every leaf of the branch a layer
    runs (``mlstm``, or ``slstm`` in an sLSTM layer) or of its ``ln1``,
    or outside the layers (``embed``, ``lm_head``, ``final_norm``), that
    is all zero, and every leaf of the branch a layer does not run that
    is not exactly zero."""
    from repro_torch.models.decoder import _is_slstm

    bad = {}
    for name, g in named_leaves(grads):
        parts = name.split(".")
        idle = False
        if parts[0] == "blocks" and parts[2] in ("mlstm", "slstm"):
            runs = "slstm" if _is_slstm(cfg, int(parts[1])) else "mlstm"
            idle = parts[2] != runs
        finite = bool(torch.isfinite(g).all())
        nonzero = bool(g.ne(0).any())
        if not finite or nonzero == idle:
            bad[name] = {"finite": finite, "idle_branch": idle,
                         "nonzero": nonzero}
    return bad


#: T3m: qwen2-moe-a2.7b at full width cut to this many of its 24 layers
#: (all 24 with AdamW would need 229 GB; 4 take 46.5 GB of state)
T3M_LAYERS = 4


def moe_training_phase(torch, device="cuda", cfg=None):
    """Gate T3m: qwen2-moe-a2.7b at full width cut to ``T3M_LAYERS``
    layers, fp32, B=1, S=2048, ``TRAIN_STEPS`` steps through the port's
    ``Trainer`` with ``launch.train``'s cosine schedule: every loss, aux
    and grad norm finite; the flash forward and backward, the router
    kernel and the gating backward launched once per layer per step,
    nothing else.  Then one more gradient pass: every leaf finite, each
    layer-stacked leaf nonzero in every layer, and each (layer, expert)
    slice of the expert weights nonzero exactly where that expert kept a
    token in that layer; a second pass from the same state, compared to
    the bit (a report); and two more steps timed in their forward,
    backward and optimizer parts.  ``device`` and ``cfg`` rehearse it on
    the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_schedule
    from repro_torch.models.moe import capacity
    from repro_torch.train import Trainer, train_state_init
    from repro_torch.tree import leaves

    full = get_config("qwen2-moe-a2.7b")
    cfg = cfg or dataclasses.replace(full, n_layers=T3M_LAYERS)
    L, B, S, K = cfg.n_layers, 1, 2048 if device == "cuda" else 64, \
        cfg.moe_top_k
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(30)
    state = train_state_init(cfg, gen, device)
    n_params = sum(p.numel() for p in leaves(state.params))
    data = make_batch_iterator(cfg.vocab, S, B, seed=30)
    trainer = Trainer(cfg, state, make_schedule("cosine", 3e-3, TRAIN_STEPS),
                      data)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_gating() as rec:
        hist = trainer.run(TRAIN_STEPS, log=None)
    sync()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    want = {k: 0 for k in counts}
    if device == "cuda":
        for k in ("flash_attention", "flash_attention_bwd", "moe_gating",
                  "moe_gating_bwd"):
            want[k] = L * TRAIN_STEPS
    series = {k: [h[k] for h in hist] for k in ("loss", "aux", "grad_norm")}
    require(len(hist) == TRAIN_STEPS, f"T3m: {len(hist)} steps recorded")
    require(all(math.isfinite(x) for v in series.values() for x in v),
            f"T3m: non-finite loss, aux or grad norm {series}")
    require(counts == want, f"T3m launches {counts} != {want}")
    ids = [r[0] for r in rec]
    require(len(ids) == L * TRAIN_STEPS, f"T3m: {len(ids)} gating calls")
    drops = dropped_by_call(cfg, ids)
    dropped_share = [[drops[t * L + j] / ids[t * L + j].numel()
                      for j in range(L)] for t in range(TRAIN_STEPS)]

    step = trainer.step_fn
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in next(data).items()}
    with recording_gating() as rec:
        _, _, grads = step.grads_of(trainer.state.params, batch)
    require(len(rec) == L, f"T3m: {len(rec)} gating calls in one pass")
    # an expert keeps a token in a layer iff any token chose it (C >= 1)
    kept = torch.stack([r[0].long().flatten().bincount(
        minlength=cfg.n_experts) > 0 for r in rec]).cpu()      # (L, E)
    require(capacity(cfg, B * S, False) >= 1, "T3m: capacity 0")
    bad, experts = {}, {}
    for name, g in named_leaves(grads):
        alive = (g.flatten(1).ne(0).any(1) if name.startswith("blocks.")
                 else g.ne(0).any()[None])
        finite = bool(torch.isfinite(g).all())
        if not finite or not bool(alive.all()):
            bad[name] = {"finite": finite,
                         "zero_layers": (~alive).nonzero().flatten().tolist()}
        if name in ("blocks.moe.w_gate", "blocks.moe.w_up",
                    "blocks.moe.w_down"):
            live = g.flatten(2).ne(0).any(2).cpu()             # (L, E)
            experts[name] = {"nonzero": int(live.sum()),
                             "mismatch": (live != kept).nonzero().tolist()}
            if experts[name]["mismatch"]:
                bad[name] = experts[name]
    require(not bad, f"T3m: gradient leaves not finite, zero in a layer, or "
            f"zero otherwise than where experts kept tokens: {bad}")
    _, _, again = step.grads_of(trainer.state.params, batch)
    repeat = all(torch.equal(a, b) for a, b in zip(leaves(grads),
                                                     leaves(again)))
    del grads, again

    state, timings = timed_steps(torch, cfg, trainer.state, data, device)
    emit({"phase": "moe_training", "model": cfg.name,
          "reduced": {"n_layers": [full.n_layers, L]}, "d_model": cfg.d_model,
          "experts": cfg.n_experts, "top_k": K, "params": n_params,
          "batch": B, "seq": S, "steps": TRAIN_STEPS, **series,
          "launches": counts, "main_wall_s": wall_s,
          "main_tokens_per_s": TRAIN_STEPS * B * S / wall_s,
          "max_memory_allocated_bytes": peak,
          "capacity": capacity(cfg, B * S, False),
          "dropped_share_by_step_and_layer": dropped_share,
          "experts_kept_by_layer": kept.sum(1).tolist(),
          "expert_grads": experts, "two_passes_bit_equal": repeat,
          "timed_steps": timings,
          "nvidia_smi": nvidia_smi() if device == "cuda" else None})
    del state, trainer
    return counts, timings[-1]


def handoff_by_layer(torch, cfg, params, tokens):
    """Gate G3's handoff, layer by layer: each layer, fed the input that
    prefill(2048) gives it, runs prefill(2048) and prefill(2047) + one
    decode step from a fresh cache; the mLSTM C and n and the sLSTM c, n
    and h agree within 1e-4 of their largest entry, every m within 1e-4.
    The prefill(2048) pass is also where every mLSTM layer's real inputs
    hold the kernel to gate G1, and its layer times give the sLSTM's
    share."""
    import dataclasses

    from repro_torch.models import decoder

    one = dataclasses.replace(cfg, n_layers=1)
    S = tokens.shape[1]
    x = params["embed"][tokens.long()]
    pos = torch.arange(S, device="cuda")[None]
    worst = {"state_rel": 0.0, "m_abs": 0.0}
    g1_worst = {}
    ms_by_kind = {"mlstm": [], "slstm": []}

    def fresh():
        return decoder.init_cache(one, 1, S + 1, device="cuda")["layers"][0]

    for j, bp in enumerate(params["blocks"]):
        kind = "slstm" if decoder._is_slstm(cfg, j) else "mlstm"
        with recording_mlstm() as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_next, whole, _ = decoder.run_block(cfg, bp, x, pos, fresh(), 0,
                                                 layer_idx=j)
            torch.cuda.synchronize()
            ms_by_kind[kind].append((time.perf_counter() - t0) * 1e3)
        require(len(rec) == (kind == "mlstm"), f"layer {j}: {len(rec)} scans")
        for args, out in rec:
            res = mlstm_g1(torch, out, args)
            require(g1_holds(res), f"layer {j}: gate G1 fails on the real "
                    f"inputs: {res}")
            for k, v in res.items():
                g1_worst[k] = max(g1_worst.get(k, 0.0), v)
        del rec
        _, part, _ = decoder.run_block(cfg, bp, x[:, :S - 1], pos[:, :S - 1],
                                       fresh(), 0, layer_idx=j)
        _, part, _ = decoder.run_block(cfg, bp, x[:, S - 1:], pos[:, S - 1:],
                                       part, S - 1, layer_idx=j)
        keys = (("C", "n"), "m") if kind == "mlstm" else (("sc", "sn", "sh"),
                                                          "sm")
        for key in keys[0]:
            a, b = part[key], whole[key]
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst["state_rel"] = max(worst["state_rel"], rel)
            require(rel <= 1e-4, f"layer {j} {key}: handoff differs by {rel} "
                    "of its largest entry")
        m_abs = (part[keys[1]] - whole[keys[1]]).abs().max().item()
        worst["m_abs"] = max(worst["m_abs"], m_abs)
        require(m_abs <= 1e-4, f"layer {j} {keys[1]}: handoff differs by "
                f"{m_abs}")
        x = x_next
    total = sum(sum(v) for v in ms_by_kind.values())
    emit({"phase": "xlstm_handoff_by_layer", "S": S, **worst,
          "tolerance": {"state_rel": 1e-4, "m_abs": 1e-4},
          "mlstm_g1_real_inputs_worst": g1_worst,
          "mlstm_layers": len(ms_by_kind["mlstm"]),
          "mlstm_layer_ms_median": statistics.median(ms_by_kind["mlstm"]),
          "slstm_layer_ms_median": statistics.median(ms_by_kind["slstm"]),
          "slstm_share_of_layer_time": sum(ms_by_kind["slstm"]) / total})


def profile_decode(torch, module, prompts, feed, steps: int = 4):
    """Where a fused decode step's time goes: ``torch.profiler`` over a
    few steps of the same feed; device busy share = summed kernel time
    over the window's wall time.  For MoE, a second window of as many steps
    that records shapes gives the router product's and the gating's device
    time per step (``router_gating_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simnet import Sim
    from repro_torch.serving import BatchEngine

    sim = Sim(seed=0)
    eng = BatchEngine(module, sim, n_slots=8, page_size=32, device="cuda")
    sessions = [f"s{i}" for i in range(len(prompts))]
    for sid, p in zip(sessions, prompts):
        sim.run_process(eng.open(sid, p, p.shape[1] + 2 * steps + 2))
    eng.step(sessions, feed[0])                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            eng.step(sessions, feed[t + 1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    moe = {}
    if module.cfg.arch == "moe":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as shaped:
            for t in range(steps):
                eng.step(sessions, feed[steps + t + 1])
            torch.cuda.synchronize()
        moe = router_gating_ms(shaped, module.cfg, len(sessions), steps)
    eng.close(sessions)
    emit({"phase": "decode_profile", "model": module.cfg.name, "steps": steps,
          **device_time(prof, wall_us, steps), **moe})


def device_time(prof, wall_us, steps) -> dict:
    """A profiled window of ``steps`` decode steps that took ``wall_us``:
    the device's busy ms a step (summed kernel time; device-side events
    only, since ops would count twice), its idle share, and the largest
    kernels."""
    from torch.autograd import DeviceType

    kernels = sorted(((ev.self_device_time_total, ev.count, ev.key)
                      for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and ev.self_device_time_total > 0), reverse=True)
    require(bool(kernels), "the profiler saw no device kernel")
    busy = sum(k[0] for k in kernels)
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "top_device_ops": [
                {"name": name[:80], "calls_per_step": n / steps,
                 "ms_per_step": us / steps / 1e3}
                for us, n, name in kernels[:12]]}


def router_gating_ms(prof, cfg, M: int, steps: int) -> dict:
    """Device ms per step of the router product and the gating in a
    profile that recorded shapes: the kernels of every ``aten::mm`` of
    shapes (M, d_model) x (d_model, n_experts), the product before it was
    folded into the gating kernel, and every kernel named ``*gating_kernel*``
    (the logits-in gating, or the router kernel that does both)."""
    from torch.autograd import DeviceType

    shapes = [[M, cfg.d_model], [cfg.d_model, cfg.n_experts]]
    product = sum(ev.device_time_total for ev in prof.key_averages(
        group_by_input_shape=True) if ev.key == "aten::mm"
        and [list(x) for x in ev.input_shapes] == shapes)
    gating = [(ev.key[:80], ev.count / steps, ev.self_device_time_total)
              for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and "gating_kernel" in ev.key]
    gating_us = sum(us for _, _, us in gating)
    return {"router_product_ms_per_step": product / steps / 1e3,
            "gating_ms_per_step": gating_us / steps / 1e3,
            "router_gating_ms_per_step": (product + gating_us) / steps / 1e3,
            "gating_kernels": [{"name": n, "calls_per_step": c}
                               for n, c, _ in gating]}


#: gate C1's constants, computed by the JAX package on the CPU from
#: ``golden_numpy_tree`` and re-derived on every run by
#: ``tests/test_torch_checkpoint.py::test_golden_constants``, which also
#: holds this copy equal to its own
CKPT_GOLDEN = {
    "fp32": {"parts_root": "70db1520b27b65798924892f066c23ee9c4d9728804a1d4e"
                           "44fc154ad711491884",
             "blob_sha256": "4dd0ec5af6514685fb3fb9c5565999fe54acd8b20afb6139"
                            "060d4b2e9727c1ad",
             "int8_blob_sha256": "9136f2b3285f236bced0e48175e53177e10497d81495"
                                 "0cde9806d673cd42738e"},
    "bf16": {"parts_root": "7020d28a37aedb25764dc77dca6d4d1f66e1bdd8ddb46fc3"
                           "833c32e6fb53591470",
             "blob_sha256": "d35af68294655ba3e28fc5b65224fdb31360bc9098a097cc"
                            "a6b8e9e143ad2b76"},
}
CKPT_GOLDEN_SEED = 24
CKPT_TRAIN_STEPS = 2
#: gates C2-C5, M2-M3 and F1-F3 run minicpm-2b at full width with its
#: depth cut to this many of its 40 layers (2.60 of the 10.9 GB; most of
#: those phases' seconds scale with the tree's bytes), so that the smoke
#: has room for training the hybrid, vlm and audio archs
CKPT_LAYERS = 6
CKPT_PROMPTS = [2048, 300, 64, 12]
CKPT_STEPS = 16


@contextlib.contextmanager
def cut_depth(arch, n_layers):
    """While the block runs, ``get_config(arch)`` (so every launcher)
    gives ``arch`` at full width cut to ``n_layers`` layers."""
    import importlib

    from repro_torch import configs

    mod = importlib.import_module(f"repro_torch.configs.{configs._MODULES[arch]}")
    full = mod.CONFIG
    mod.CONFIG = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield mod.CONFIG
    finally:
        mod.CONFIG = full


def golden_numpy_tree(like, seed=CKPT_GOLDEN_SEED):
    """Gate C1's tree: ``like``'s structure (nested dicts of tensors or
    arrays), every leaf uniform in [-1, 1) as float32, drawn from one
    legacy ``RandomState`` (whose stream numpy keeps fixed across
    versions) in the order of the leaves' ``/``-joined paths, the order
    the checkpoint format sorts them in."""
    import numpy as np

    rs = np.random.RandomState(seed)
    vals = {name: rs.uniform(-1.0, 1.0, tuple(leaf.shape)).astype(np.float32)
            for name, leaf in sorted(named_leaves(like, sep="/"))}

    def build(tree, prefix):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
                else vals[f"{prefix}{k}"] for k, v in tree.items()}
    return build(like, "")


def cid_hex(cid) -> str:
    return f"{cid.codec:02x}{cid.digest.hex()}"


def checkpoint_digests(tree, int8: bool) -> dict:
    """Gate C1's readings of one tree: the parts' v2 root CID, the sha256
    of the LCK2 blob and, with ``int8``, of the LCK3 one."""
    import hashlib

    from repro_torch.checkpoint import params_to_bytes, params_to_parts
    from repro_torch.core.cid import build_tree_dag

    out = {"parts_root": cid_hex(build_tree_dag(params_to_parts(tree)).root),
           "blob_sha256": hashlib.sha256(params_to_bytes(tree)).hexdigest()}
    if int8:
        out["int8_blob_sha256"] = hashlib.sha256(
            params_to_bytes(tree, quant="int8_block")).hexdigest()
    return out


def golden_trees(torch, device):
    """Gate C1's fp32 tree and its bf16 cast (round to nearest even) on
    ``device``: a reduced minicpm-2b (``T2_REDUCED``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    from repro_torch.params import params_from_numpy
    from repro_torch.tree import tree_map

    cfg = get_config("minicpm-2b").reduced(**T2_REDUCED)
    like = decoder.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree32 = params_from_numpy(golden_numpy_tree(like), device)
    return {"fp32": tree32,
            "bf16": tree_map(lambda t: t.to(torch.bfloat16), tree32)}


def _rss_bytes() -> int:
    """The process's resident set now, in bytes (Linux)."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _file_sha256(path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(64 * 2 ** 20):
            h.update(chunk)
    return h.hexdigest()


def _rss_stage(stages, name, fn):
    """Run ``fn`` as a named stage: its seconds, and the resident set
    before it and at its peak, sampled every 2 ms on a thread (the copies,
    writes and hashes it waits on release the interpreter lock).  A stage
    run again adds its seconds and keeps its first ``rss_before_bytes``
    and its highest peak."""
    import threading

    before = _rss_bytes()
    peak = [before]
    done = threading.Event()

    def sample():
        while not done.wait(0.002):
            peak[0] = max(peak[0], _rss_bytes())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        seconds = time.perf_counter() - t0
        done.set()
        sampler.join()
    seen = stages.setdefault(name, {"s": 0.0, "rss_before_bytes": before,
                                    "peak_rss_bytes": 0})
    seen["s"] += seconds
    seen["peak_rss_bytes"] = max(seen["peak_rss_bytes"], peak[0],
                                 _rss_bytes())
    return out


@contextlib.contextmanager
def call_seconds(table, targets, sync=None):
    """While the block runs, each ``(owner, attribute)`` of ``targets`` is
    timed: its calls and wall seconds add up in ``table`` under the
    attribute's name, ``sync()`` (the card's, when given) run before the
    clock is read, so that a call's queued device work counts as its
    own."""
    saved = []
    for owner, attr in targets:
        fn = getattr(owner, attr)

        def timed(*args, _fn=fn, _name=attr, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                if sync is not None:
                    sync()
                row = table.setdefault(_name, {"calls": 0, "s": 0.0})
                row["calls"] += 1
                row["s"] += time.perf_counter() - t0
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)
    try:
        yield table
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def served_prompts(cfg, lengths=CKPT_PROMPTS):
    """Gates C4's, M3's and F1's prompts (D4's with ``lengths``):
    ``lengths`` tokens each, from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
            for n in lengths]


def same_served_tokens(torch, cfg, tree_a, tree_b, gate, device="cuda",
                       lengths=CKPT_PROMPTS, steps=CKPT_STEPS):
    """Gates C4, M3 and D4: ``tree_a`` and then ``tree_b`` served through
    the fused ``BatchEngine`` (prompts of ``lengths`` tokens, ``steps``
    greedy steps, page 32) give bit-equal logits rows, the same greedy
    tokens and the same launch counts, paged decode's among them, and
    flash attention's exactly when a prompt reaches ``FLASH_MIN_SEQ``.
    Returns the counts, the tokens (session, step) and ``tree_b``'s run as
    gate F1's reference: the prefill logits (session, vocab) and each
    step's logits (session, vocab)."""
    import numpy as np

    from repro_torch.core.simnet import Sim
    from repro_torch.kernels import ops
    from repro_torch.models.common import FLASH_MIN_SEQ
    from repro_torch.serving import BatchEngine, ShardModule, split_params

    L = cfg.n_layers
    prompts = served_prompts(cfg, lengths)
    runs = []
    for tree in (tree_a, tree_b):
        module = ShardModule(cfg, split_params(cfg, tree, [(0, L)])[0],
                             (0, L), is_first=True, is_last=True)
        sim = Sim(seed=0)
        eng = BatchEngine(module, sim, n_slots=len(prompts),
                          page_size=32, device=device)
        ops.reset_launch_counts()
        with torch.no_grad():
            run = _drive(eng, sim, prompts, steps)
        runs.append((run, ops.launch_counts()))
        del eng, module
    (ra, ca), (rb, cb) = runs
    require(ca == cb, f"{gate}: launches {ca} != {cb}")
    long_prompt = max(lengths) >= FLASH_MIN_SEQ
    require((ca["flash_attention"] > 0) == long_prompt
            and ca["paged_decode_attention"] > 0, f"{gate}: launches {ca}")
    require(all(np.array_equal(x, y) for x, y in zip(ra[4], rb[4])),
            f"{gate}: the greedy tokens differ")
    require(np.array_equal(ra[0], rb[0]) and all(
        np.array_equal(x, y) for x, y in zip(ra[2], rb[2])),
        f"{gate}: the logits differ")
    tokens = np.stack(ra[4]).T.tolist()
    reference = (rb[0], rb[2])
    del runs, ra, rb
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return ca, tokens, reference


def checkpoint_phase(torch):
    """Gates C1-C5: the checkpoint format on the card, then minicpm-2b
    trained at full width, saved, loaded back and served."""
    import os
    import resource
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import (load_local, params_to_bytes,
                                        params_to_parts, save_local)
    from repro_torch.configs import get_config
    from repro_torch.core.cid import build_tree_dag
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import decoder
    from repro_torch.serving import GenerationEngine

    t_phase = time.perf_counter()
    # C1: golden CIDs of card-held trees
    golden = {k: checkpoint_digests(t, int8=k == "fp32")
              for k, t in golden_trees(torch, "cuda").items()}
    require(golden == CKPT_GOLDEN, f"C1: {golden} != {CKPT_GOLDEN}")

    cfg = get_config("minicpm-2b")
    L, S = cfg.n_layers, 2048
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="ckpt-") as tmp:
        path = os.path.join(tmp, "minicpm-2b.lck")
        trainer = launch_train.run([
            "--arch", "minicpm-2b", "--steps", str(CKPT_TRAIN_STEPS),
            "--batch", "1", "--seq", str(S)])
        hist = trainer.history
        require(len(hist) == CKPT_TRAIN_STEPS and all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in hist), f"C2: training history {hist}")
        train_peak = torch.cuda.max_memory_allocated()
        trained = trainer.state.params
        torch.cuda.synchronize()

        # C2: save as --save does, free the moments, load into a fresh init
        save_t = {}
        n_written = _rss_stage(stages, "save", lambda: save_local(
            path, trained, timings=save_t))
        file_bytes = os.path.getsize(path)
        require(n_written == file_bytes, f"C2: wrote {n_written} bytes, "
                f"the file holds {file_bytes}")
        trainer.state = trainer.state._replace(opt=None)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the trainer's own start (launch.train's seed 0)
        fresh = decoder.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        load_t = {}
        loaded = _rss_stage(stages, "load", lambda: load_local(
            path, like=fresh, timings=load_t))
        want = dict(named_leaves(trained))
        init = dict(named_leaves(fresh))
        require(sorted(want) == sorted(dict(named_leaves(loaded))),
                "C2: the loaded tree has other leaves")
        moved = 0
        for name, b in named_leaves(loaded):
            a = want[name]
            require(b.device.type == "cuda" and b.dtype == a.dtype
                    and b.shape == a.shape, f"C2: {name} came back as "
                    f"{b.dtype} {tuple(b.shape)} on {b.device}")
            require(torch.equal(a.detach(), b), f"C2: {name} differs")
            moved += not torch.equal(init[name], b)
        require(moved > 0, "C2: every loaded leaf equals the fresh init")
        del fresh, init, want

        # C3: the canonical bytes and the parts root are stable
        file_sha = _rss_stage(stages, "file_sha256",
                              lambda: _file_sha256(path))

        def blob_sha():
            import hashlib
            return hashlib.sha256(params_to_bytes(loaded)).hexdigest()
        loaded_sha = _rss_stage(stages, "bytes_sha256", blob_sha)
        require(loaded_sha == file_sha, f"C3: params_to_bytes(loaded) hashes "
                f"to {loaded_sha}, the file to {file_sha}")
        def parts_dag(tree):
            dag = build_tree_dag(params_to_parts(tree))
            return cid_hex(dag.root), list(dag.entries)
        # the trained tree's DAG entries go on to the mesh phase (gate M2)
        (root_a, trained_entries), (root_b, _) = [
            _rss_stage(stages, f"parts_root_{k}", lambda t=t: parts_dag(t))
            for k, t in (("trained", trained), ("loaded", loaded))]
        roots = [root_a, root_b]
        require(roots[0] == roots[1], f"C3: parts roots {roots}")

        # C4: both trees serve the same tokens through the fused engine
        ca, c4_tokens, _ = same_served_tokens(torch, cfg, trained, loaded,
                                              "C4")
        del loaded
        gc.collect()
        torch.cuda.empty_cache()

        # C5: the user's entry point serves the checkpoint
        B, P, G = 2, 64, 8
        t0 = time.perf_counter()
        served = launch_serve.main([
            "--arch", "minicpm-2b", "--load", path, "--batch", str(B),
            "--prompt-len", str(P), "--gen", str(G)])
        serve_s = time.perf_counter() - t0
        tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, P),
                                                   dtype=np.int32)
        with torch.no_grad():
            want, _ = GenerationEngine(cfg, trained, max_len=P + G + 1,
                                       device="cuda").generate(
                                           {"tokens": tokens}, G)
        # the untrained start (launch.serve's own init) on the same batch
        start = decoder.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        with torch.no_grad():
            start_tokens, _ = GenerationEngine(
                cfg, start, max_len=P + G + 1, device="cuda").generate(
                    {"tokens": tokens}, G)
        del start
        require(np.array_equal(served, want),
                f"C5: served {served.tolist()} != {want.tolist()}")
        require(not np.array_equal(start_tokens, want),
                f"C5: the trained tree and the untrained start both serve "
                f"{want.tolist()}, so the tokens cannot tell a loaded "
                "checkpoint from an ignored --load")
        card_peak = torch.cuda.max_memory_allocated()
    gb = file_bytes / 1e9
    emit({"phase": "checkpoint", "phase_s": time.perf_counter() - t_phase,
          "model": cfg.name, "n_layers": L,
          "train_steps": CKPT_TRAIN_STEPS, "loss": [h["loss"] for h in hist],
          "golden": golden, "file_bytes": file_bytes,
          "root_cid": roots[0], "file_sha256": file_sha,
          "save_s": stages["save"]["s"], "save_split_s": save_t,
          "load_s": stages["load"]["s"], "load_split_s": load_t,
          "save_gb_per_s": {k: gb / v for k, v in save_t.items() if v > 0},
          "load_gb_per_s": {k: gb / v for k, v in load_t.items() if v > 0},
          "parts_root_s": {k: stages[f"parts_root_{k}"]["s"]
                           for k in ("trained", "loaded")},
          "stages": stages, "serve_main_s": serve_s,
          "c4_launches": ca, "c4_tokens": c4_tokens,
          "c5_tokens": served.tolist(),
          "c5_untrained_tokens": start_tokens.tolist(),
          "peak_rss_bytes_process": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss * 1024,
          "max_memory_allocated_bytes_training": train_peak,
          "max_memory_allocated_bytes_after": card_peak,
          "nvidia_smi": nvidia_smi()})
    return trained, trained_entries


# ------------------------------------------------------------------- mesh

#: gates M1-M3: the fleet's seed, the model fleet's name and the step the
#: tree is published at
MESH_SEED = 26
MESH_FLEET = "minicpm"
MESH_STEP = CKPT_TRAIN_STEPS
#: simulated seconds the sanitized run goes on after the fetch, so that
#: the announcement's gossip and the re-provide settle before the report
MESH_DRAIN_S = 30.0
#: gate M1's constants: ``mesh_scenario`` over gate C1's fp32 tree under
#: ``Sim(seed=MESH_SEED, sanitize=True)``, computed through the JAX
#: package on the CPU and re-derived there through both packages by
#: ``tests/test_torch_mesh.py::test_mesh_golden_constants``
MESH_GOLDEN = {
    "root": "7025273e2922759931402c9518aeed212a077886d77d096c2dd8f5f143bcf4"
            "0e12",
    "trace_digest": "b8fa0ea036450b270ff44d6ee0e4459b4765cf5b7d89d92623009055"
                    "e6645d78",
    "events": 3404, "fetch_sim_s": 5.805796943874329}


def port_mesh():
    """The port's mesh modules as ``mesh_scenario`` takes them (the CPU
    test hands it the JAX package's)."""
    from types import SimpleNamespace

    from repro_torch.checkpoint import lattica_ckpt
    from repro_torch.core import cid, fleet, nat, pubsub, simnet, traversal

    return SimpleNamespace(ckpt=lattica_ckpt, cid=cid, fleet=fleet, nat=nat,
                           pubsub=pubsub, simnet=simnet, traversal=traversal)


def fresh_counters(mesh) -> None:
    """Restart the process-wide sequence counters of ``mesh``'s package as
    a new process starts them: ``simnet.Host._ip_seq`` and
    ``nat.NATBox._ip_seq`` number the hosts' and NAT boxes' addresses,
    ``pubsub._seq`` messages and ``traversal._req_seq`` requests and punch
    nonces.  Addresses reach the published meta (and so the root CID), and
    all four reach pickled sizes and so the simulated timings: without
    this, a scenario's trace would depend on what ran before it in the
    process."""
    import itertools

    mesh.simnet.Host._ip_seq = itertools.count(1)
    mesh.nat.NATBox._ip_seq = itertools.count(1)
    mesh.pubsub._seq = itertools.count(1)
    mesh.traversal._req_seq = itertools.count(1)


def mesh_nat_kinds(mesh, seed=MESH_SEED):
    """The four peers' NAT specs: the publisher behind a port-restricted
    cone NAT, the fetcher behind a symmetric NAT with random port
    allocation, then two peers drawn from ``DEFAULT_NAT_MIX`` (a symmetric
    one's allocator from ``DEFAULT_SYM_ALLOC_MIX``) by a seeded
    generator."""
    import random

    kind, alloc = mesh.nat.NATKind, mesh.nat.PortAlloc
    rng = random.Random(seed)
    kinds, weights = zip(*mesh.fleet.DEFAULT_NAT_MIX)
    allocs = [(a, d) for a, d, _ in mesh.fleet.DEFAULT_SYM_ALLOC_MIX]
    alloc_weights = [w for _, _, w in mesh.fleet.DEFAULT_SYM_ALLOC_MIX]
    specs = [kind.PORT_RESTRICTED, (kind.SYMMETRIC, alloc.RANDOM, 1)]
    for _ in range(2):
        k = rng.choices(kinds, weights=weights)[0]
        specs.append((k, *rng.choices(allocs, weights=alloc_weights)[0])
                     if k is kind.SYMMETRIC else k)
    return specs


def mesh_scenario(mesh, tree, like, sanitize, by_root=False,
                  stage=lambda name, fn: fn()):
    """Gates M1 and M2's run.  From ``fresh_counters``, ``make_fleet(4,
    ...)`` (the reference's two bootstrap/relay servers,
    ``mesh_nat_kinds``) under ``Sim(seed=MESH_SEED, sanitize=sanitize)``;
    the publisher (peer0) publishes ``tree`` as step ``MESH_STEP`` of
    ``MESH_FLEET``; the fetcher (peer1) syncs its registry with the
    publisher and fetches the version into
    ``like``'s structure and devices, by ``fetch_latest`` or, with
    ``by_root``, by ``fetch_checkpoint`` of the registry's latest root;
    then both nodes finish: they release their lineage pins and the
    fetcher closes its connection to the publisher.  The leak audit is
    taken against the fleet as built, before the finish (``leaks_held``)
    and after it; a sanitized run goes on ``MESH_DRAIN_S`` simulated
    seconds before its report.  ``stage(name, fn)`` runs the publish
    (``"publish"``) and the fetch (``"fetch"``)."""
    ckpt = mesh.ckpt
    fresh_counters(mesh)
    sim = mesh.simnet.Sim(seed=MESH_SEED, sanitize=sanitize)
    fleet = mesh.fleet.make_fleet(4, nat_kinds=mesh_nat_kinds(mesh),
                                  sim=sim)
    pub, fetcher = fleet.peers[0], fleet.peers[1]
    sim.leak_baseline()
    punched = [n.transport.stats["punch_ok"] for n in (pub, fetcher)]

    def publish():
        return (yield from ckpt.publish_checkpoint(pub, tree, MESH_STEP,
                                                   MESH_FLEET))

    def fetch():
        yield from fetcher.sync_crdt_with(pub.info())
        t0 = sim.now
        if by_root:
            step, root = ckpt.CheckpointRegistry(fetcher, MESH_FLEET).latest()
            got = yield from ckpt.fetch_checkpoint(fetcher, root, like,
                                                   fleet=MESH_FLEET)
        else:
            step, got = yield from ckpt.fetch_latest(fetcher, MESH_FLEET,
                                                     like=like)
        return step, got, sim.now - t0

    root = stage("publish", lambda: sim.run_process(publish()))
    step, got, fetch_sim_s = stage("fetch", lambda: sim.run_process(fetch()))
    conn = fetcher.host.connection_to(pub.host)
    path = ("none" if conn is None else "relayed" if conn.relayed
            else "dcutr" if [n.transport.stats["punch_ok"]
                             for n in (pub, fetcher)] != punched
            else "direct")
    entries = [(e.name, cid_hex(e.cid)) for e in
               mesh.cid.decode_manifest_v2(fetcher.blockstore.peek(root))[0]]
    # the reference's streaming fetch never closes the fetcher's end of a
    # channel (``bitswap.py`` ``_fetch_blocks_stream``): the audit taken
    # here shows each one as a half-open stream while the connection lives
    leaks_held = sim.leak_audit()
    # both nodes finish: the lineage pins go, the fetcher hangs up
    for node in (pub, fetcher):
        node.unpin_latest(f"ckpt/{MESH_FLEET}")
    for c in list(fetcher.host._connections.get(pub.host.name, [])):
        c.close()
    out = {"root": cid_hex(root), "step": step, "fetched": got,
           "fetch_sim_s": fetch_sim_s, "entries": entries, "path": path,
           "bytes_fetched": fetcher.bitswap.stats["bytes_fetched"],
           "bitswap": {"publisher": dict(pub.bitswap.stats),
                       "fetcher": dict(fetcher.bitswap.stats)},
           "nat": [fleet.nat_kind_of(n) for n in fleet.peers],
           "leaks_held": leaks_held}
    if sanitize:
        sim.run(until=sim.now + MESH_DRAIN_S)
        out["san"] = sim.san_report()
    out["leaks"] = sim.leak_audit()
    return out


def mesh_golden(run) -> dict:
    """Gate M1's readings of one ``mesh_scenario`` run."""
    return {"root": run["root"], "trace_digest": run["san"]["trace_digest"],
            "events": run["san"]["events"], "fetch_sim_s": run["fetch_sim_s"]}


@contextlib.contextmanager
def staged_calls(stages, module, stage_of):
    """While open, every call of a function ``module.<attr>`` named in
    ``stage_of`` (the module's own calls included) runs as the
    ``_rss_stage`` ``stage_of[attr]`` of ``stages``; the functions are put
    back on exit."""
    saved = {attr: getattr(module, attr) for attr in stage_of}

    def timed(fn, name):
        def call(*args, **kwargs):
            return _rss_stage(stages, name, lambda: fn(*args, **kwargs))
        return call
    try:
        for attr, name in stage_of.items():
            setattr(module, attr, timed(saved[attr], name))
        yield
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def mesh_phase(torch, trained, trained_entries, t_main, device="cuda",
               cfg=None):
    """Gates M1-M3: the port's mesh publishes gate C1's tree from behind a
    port-restricted cone NAT and fetches it onto the card from behind a
    symmetric one, sanitized and against golden constants; then the
    trained minicpm-2b at full width (``cfg``, by default), served
    afterwards beside the tree it was published from.  ``device`` is the
    card's; a CPU rehearsal passes ``"cpu"`` and a reduced ``cfg``.
    Returns the fetched tree and M3's run of it (``same_served_tokens``'
    reference), which the fleet phase serves and holds to."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder

    t_phase = time.perf_counter()
    mesh = port_mesh()

    # M1: reduced size, golden and sanitized, twice
    small = golden_trees(torch, device)["fp32"]
    want = dict(named_leaves(small))
    cfg_small = get_config("minicpm-2b").reduced(**T2_REDUCED)
    m1 = []
    for _ in range(2):
        like = decoder.init_params(
            cfg_small, torch.Generator(device=device).manual_seed(0), device)
        run = mesh_scenario(mesh, small, like, sanitize=True)
        got = dict(named_leaves(run.pop("fetched")))
        require(sorted(got) == sorted(want), "M1: other leaves came back")
        for name, b in got.items():
            require(b.device.type == device and torch.equal(want[name], b),
                    f"M1: {name} differs or is not on the card")
        san = run["san"]
        require(run["step"] == MESH_STEP, f"M1: step {run['step']}")
        require(not san["double_settles"] and not san["orphans"]
                and not san["leaks"] and not run["leaks"],
                f"M1: sanitizer report {san}, leaks {run['leaks']}")
        require(mesh_golden(run) == MESH_GOLDEN,
                f"M1: {mesh_golden(run)} != {MESH_GOLDEN}")
        m1.append(run)
    require(m1[0]["san"] == m1[1]["san"], "M1: the two runs differ")
    del small, want, like, got

    # M2: the trained tree at full width, published from the card and
    # fetched into a fresh init on it
    cfg = cfg or get_config("minicpm-2b")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fresh = decoder.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    stages = {}
    with staged_calls(stages, mesh.ckpt, {
            "params_to_parts": "params_to_parts",
            "build_tree_dag": "dag_build", "read_dag": "reassembly",
            "leaf_from_part": "reassembly",
            "params_from_parts": "copy_to_card"}):
        m2 = mesh_scenario(
            mesh, trained, fresh, sanitize=False, by_root=True,
            stage=lambda name, fn: _rss_stage(stages, name, fn))
    # the publish and the fetch hold the stages inside them
    stages["publish_provide_s"] = stages["publish"]["s"] - sum(
        stages[k]["s"] for k in ("params_to_parts", "dag_build"))
    stages["fetch_s"] = stages["fetch"]["s"] - sum(
        stages[k]["s"] for k in ("reassembly", "copy_to_card"))
    fetched = m2.pop("fetched")
    want = dict(named_leaves(trained))
    got = dict(named_leaves(fetched))
    require(sorted(got) == sorted(want), "M2: other leaves came back")
    for name, b in got.items():
        a = want[name]
        require(b.device.type == device and b.dtype == a.dtype
                and b.shape == a.shape, f"M2: {name} came back as {b.dtype} "
                f"{tuple(b.shape)} on {b.device}")
        require(torch.equal(a.detach(), b), f"M2: {name} differs")
    c3 = [(e.name, cid_hex(e.cid)) for e in trained_entries]
    require(m2["entries"] == c3,
            "M2: the root manifest's entries are not the trained tree's")
    require(not m2["leaks"], f"M2: leak audit {m2['leaks']}")
    del fresh, want, got
    gc.collect()
    card_peak = None
    if on_card:
        torch.cuda.empty_cache()
        card_peak = torch.cuda.max_memory_allocated()

    # M3: the fetched tree serves what the trained tree serves
    m3_counts, m3_tokens, reference = same_served_tokens(
        torch, cfg, trained, fetched, "M3", device)
    emit({"phase": "mesh", "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": nvidia_smi(), "model": cfg.name,
          "m1": [dict(mesh_golden(r), path=r["path"], nat=r["nat"],
                      bytes_fetched=r["bytes_fetched"]) for r in m1],
          "root_cid": m2["root"], "nat": m2["nat"], "path": m2["path"],
          "fetch_sim_s": m2["fetch_sim_s"],
          "bytes_fetched": m2["bytes_fetched"], "bitswap": m2["bitswap"],
          "leaks_held": m2["leaks_held"], "stages": stages,
          "m3_launches": m3_counts, "m3_tokens": m3_tokens,
          "max_memory_allocated_bytes": card_peak,
          "smoke_s": time.perf_counter() - t_main})
    return fetched, reference


# ------------------------------------------------------------------ fleet

#: the serving fleet's seed, its name, and its shape: 2 shards (layers
#: 0-2 and 3-5 of minicpm-2b cut to ``CKPT_LAYERS``) x 2 replicas, 4 slots
#: each
FLEET_SEED = 27
FLEET_NAME = "fleet"
FLEET_SHARDS = 2
FLEET_REPLICAS = 2
FLEET_SLOTS = 4
#: gate F1's logits bound, relative to max(1, max|reference row|)
FLEET_REL = 1e-4
#: simulated seconds the fleet runs on after a generation, so that the
#: client's close RPCs land before the slots and pages are read
FLEET_DRAIN_S = 30.0
#: polls of 10 simulated ms for a busy shard-1 replica to stop (gate F2)
FLEET_POLLS = 3000


def fleet_nat_kinds(mesh):
    """The six peers' NAT specs.  Peers 0-3 serve (``deploy_sharded``
    places shard i of replica r on peer r * 2 + i): shard 0 behind no NAT
    and behind a symmetric NAT with random ports, shard 1 behind a full
    cone and a restricted cone NAT; peer 4 behind a symmetric NAT with
    sequential ports stays idle; peer 5, the client, behind a
    port-restricted cone NAT.  The client reaches the symmetric-random
    replica only through a relay (2 MB/s)."""
    kind, alloc = mesh.nat.NATKind, mesh.nat.PortAlloc
    return [None, kind.FULL_CONE, (kind.SYMMETRIC, alloc.RANDOM, 1),
            kind.RESTRICTED_CONE, (kind.SYMMETRIC, alloc.SEQUENTIAL, 1),
            kind.PORT_RESTRICTED]


def fleet_hold(tokens, rows, reference, n_tokens, gate):
    """Gate F1's comparison of one generation.  ``tokens[s]`` is session
    s's generated tokens, ``rows[(s, k)]`` the logits its client sampled
    token k from.  Tokens equal the reference's greedy tokens; a first
    difference is allowed only where the reference's top two logits lie
    within ``TIE_GAP``, and that session's comparison stops there.  Every
    compared logits row lies within ``FLEET_REL`` * max(1, max|ref row|)
    of the reference's.  Returns the rows compared, the rows equal to the
    bit, the largest relative difference and the tie stops."""
    import numpy as np

    first, steps = reference
    compared = bit_equal = 0
    worst, ties = 0.0, []
    for s, got in enumerate(tokens):
        require(got is not None, f"{gate}: session {s} failed")
        require(len(got) == n_tokens and sorted(
            k for (t, k) in rows if t == s) == list(range(n_tokens)),
            f"{gate}: session {s} has {len(got)} tokens")
        for k in range(n_tokens):
            ref = np.asarray(first[s] if k == 0 else steps[k - 1][s])
            row = rows[(s, k)]
            scale = max(1.0, float(np.abs(ref).max()))
            diff = float(np.abs(row - ref).max()) / scale
            require(diff <= FLEET_REL, f"{gate}: session {s} token {k}: "
                    f"logits differ by {diff} of max(1, max|ref|)")
            worst = max(worst, diff)
            compared += 1
            bit_equal += bool(np.array_equal(row, ref))
            want = int(np.argmax(ref))
            if int(got[k]) != want:
                top = np.sort(ref)[-2:]
                require(float(top[1] - top[0]) <= TIE_GAP,
                        f"{gate}: session {s} token {k}: {int(got[k])} != "
                        f"{want} with a gap of {float(top[1] - top[0])}")
                ties.append((s, k))
                break
    return {"rows": compared, "bit_equal_rows": bit_equal,
            "max_rel_diff": worst, "tie_stops": ties}


def fleet_phase(torch, tree, reference, t_main, device="cuda", cfg=None):
    """Gates F1-F3: the port's serving fleet over the port's mesh, at full
    width (``cfg``: minicpm-2b by default) on ``tree``, the tree gate M2
    fetched onto the card; ``reference`` is M3's run of it
    (``same_served_tokens``).  ``serve_fleet`` of 2 shards x 2 replicas, 4 slots each,
    on four of six peers behind NATs (``fleet_nat_kinds``), all on the
    card and sharing the tree's storage; a ``ShardClient`` on the sixth
    generates ``CKPT_STEPS`` greedy tokens for each of ``served_prompts``
    at once (F1), then again while a busy shard-1 replica is stopped (F2).
    ``device`` is the card's; a CPU rehearsal passes ``"cpu"`` and a
    reduced ``cfg``."""
    import itertools

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import FLASH_MIN_SEQ
    from repro_torch.serving import ShardClient, serve_fleet, sharded

    cfg = cfg or get_config("minicpm-2b")
    t_phase = time.perf_counter()
    on_card = device == "cuda"
    prompts = served_prompts(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mesh = port_mesh()
    fresh_counters(mesh)
    sharded._session_seq = itertools.count(1)     # the fleet's fifth counter
    sim = mesh.simnet.Sim(seed=FLEET_SEED)
    fleet = mesh.fleet.make_fleet(6, nat_kinds=fleet_nat_kinds(mesh),
                                  sim=sim)
    peers = fleet.peers
    stages = {}
    ops.reset_launch_counts()
    servers = _rss_stage(stages, "serve_fleet", lambda: sim.run_process(
        serve_fleet(peers[:FLEET_SHARDS * FLEET_REPLICAS], cfg, tree,
                    FLEET_NAME, replicas=FLEET_REPLICAS,
                    n_slots=FLEET_SLOTS)))
    require(all(s.engine.device.type == device and s.engine.fused
                for s in servers), "F3: a shard's engine is off the card "
            "or not fused")
    # each shard's own record of its work: prefill lengths, live steps
    work = [{"prefill_lens": [], "live_steps": 0} for _ in servers]
    for s, w in zip(servers, work):
        eng = s.engine

        def prefill(session, slot, x, max_len, _f=eng._prefill, _w=w):
            _w["prefill_lens"].append(int(np.asarray(x).shape[1]))
            return _f(session, slot, x, max_len)

        def step(sessions, x, _f=eng._step_fused, _w=w):
            out = _f(sessions, x)
            _w["live_steps"] += bool(out[1])
            return out
        eng._prefill, eng._step_fused = prefill, step
    client = ShardClient(peers[5], cfg, FLEET_NAME, n_shards=FLEET_SHARDS)
    index = {p.shape[1]: i for i, p in enumerate(prompts)}
    rows = {}

    def sample(req, logits, _f=client._sample):
        rows[(index[req.prompt.shape[1]], len(req.generated))] = \
            np.array(logits, dtype=np.float32)
        return _f(req, logits)
    client._sample = sample

    def drained(gate):
        sim.run(until=sim.now + FLEET_DRAIN_S)
        for s in servers:
            if s.alive:
                require(s.engine.slots_used == 0
                        and s.engine.stats["pages"] == 0,
                        f"{gate}: shard {s.shard_idx} on {s.node.host.name} "
                        f"holds {s.engine.slots_used} slots, "
                        f"{s.engine.stats['pages']} pages")

    # F1: every session through the fleet, held to the reference
    def f1():
        return (yield from client.generate_concurrent(
            [dict(tokens=p, n_tokens=CKPT_STEPS) for p in prompts]))
    with torch.no_grad():
        outs = _rss_stage(stages, "f1", lambda: sim.run_process(f1()))
    f1_stats = dict(client.stats)
    require(f1_stats["failed_sessions"] == 0, f"F1: {f1_stats}")
    f1 = fleet_hold(outs, rows, reference, CKPT_STEPS, "F1")
    f1["tokens"] = [o.tolist() for o in outs]
    drained("F3 after F1")

    # F2: the same prompts again; the first busy shard-1 replica stops
    rows.clear()
    killed = {}

    def f2():
        evs = [client.submit(p, CKPT_STEPS) for p in prompts]
        busy = []
        for _ in range(FLEET_POLLS):
            yield sim.timeout(0.01)
            busy = [s for s in servers if s.alive and s.shard_idx == 1
                    and s.engine.slots_used > 0]
            if busy:
                break
        require(busy, "F2: no shard-1 replica held a slot")
        victim = busy[0]
        killed.update(server=victim, at=sim.now,
                      slots=victim.engine.slots_used,
                      stats=dict(victim.engine.stats))
        victim.stop()
        res = []
        for ev in evs:
            res.append((yield ev))
        return res
    migrated0 = client.stats["sessions_migrated"]
    failed0 = client.stats["failed_sessions"]
    with torch.no_grad():
        outs = _rss_stage(stages, "f2", lambda: sim.run_process(f2()))
    f2_stats = dict(client.stats)
    require(f2_stats["failed_sessions"] == failed0, f"F2: {f2_stats}")
    require(f2_stats["sessions_migrated"] - migrated0 >= 1,
            f"F2: no session migrated: {f2_stats}")
    f2 = fleet_hold(outs, rows, reference, CKPT_STEPS, "F2")
    f2["tokens"] = [o.tolist() for o in outs]
    victim = killed["server"]
    work_keys = ("admitted", "prefills", "steps", "step_sessions")
    require(all(victim.engine.stats[k] == killed["stats"][k]
                for k in work_keys), "F2: work reached the stopped server: "
            f"{ {k: victim.engine.stats[k] for k in work_keys} } after "
            f"{ {k: killed['stats'][k] for k in work_keys} }")
    drained("F3 after F2")

    # F3: only the paged and flash kernels, as many as the shards' work
    counts = ops.launch_counts()
    predicted = {k: 0 for k in counts}
    for s, w in zip(servers, work):
        L = s.module.n_layers
        require(len(w["prefill_lens"]) == s.engine.stats["prefills"]
                and w["live_steps"] <= s.engine.stats["steps"],
                f"F3: the record of shard {s.shard_idx} on "
                f"{s.node.host.name} disagrees with its engine's stats")
        predicted["paged_decode_attention"] += L * w["live_steps"]
        predicted["flash_attention"] += L * sum(
            n >= FLASH_MIN_SEQ for n in w["prefill_lens"])
    require(counts == predicted, f"F3: launches {counts} != {predicted}")
    require(counts["paged_decode_attention"] > 0
            and counts["flash_attention"] > 0, f"F3: launches {counts}")
    card_peak = torch.cuda.max_memory_allocated() if on_card else None

    def path(a, b):
        conn = a.host.connection_to(b.host)
        if conn is None:
            return "none"
        return "relayed" if conn.relayed else "direct"
    rpc = {}
    for method in ("open", "step"):
        lat, calls, errors = [], 0, 0
        for wire, st in client.node.rpc_metrics.client.items():
            if wire.startswith(f"infer.v2.{method}."):
                lat += list(st.latencies)
                calls += st.calls
                errors += st.errors
        rpc[method] = {"calls": calls, "errors": errors,
                       "median": statistics.median(lat) if lat else None,
                       "max": max(lat) if lat else None}
    emit({"phase": "fleet", "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": nvidia_smi(), "model": cfg.name,
          "shards": [(s.node.host.name, s.shard_idx, s.module.lo,
                      s.module.hi) for s in servers],
          "nat": {n.host.name: fleet.nat_kind_of(n) for n in peers},
          "paths": {"client_shard": {
                        f"{s.node.host.name}/{s.shard_idx}": path(
                            client.node, s.node) for s in servers},
                    "shard_shard": {
                        f"{a.node.host.name}-{b.node.host.name}": path(
                            a.node, b.node)
                        for a in servers for b in servers
                        if a.shard_idx == 0 and b.shard_idx == 1}},
          "rpc_sim_s": rpc,
          "wall_s": {k: stages[k]["s"] for k in ("serve_fleet", "f1", "f2")},
          "peak_rss_bytes": {k: stages[k]["peak_rss_bytes"]
                             for k in ("serve_fleet", "f1", "f2")},
          "max_memory_allocated_bytes": card_peak,
          "f1": dict(f1, client=f1_stats,
                     failed_sessions=f1_stats["failed_sessions"]),
          "f2": dict(f2, client=f2_stats, killed=(
              killed["server"].node.host.name, killed["at"],
              killed["slots"]),
              sessions_migrated=f2_stats["sessions_migrated"] - migrated0),
          "f3": {"launches": counts, "predicted": predicted,
                 "work": [dict(w, host=s.node.host.name, shard=s.shard_idx,
                               steps=s.engine.stats["steps"],
                               pages_peak=s.engine.stats["pages_peak"])
                          for s, w in zip(servers, work)]},
          "sim_s": sim.now, "smoke_s": time.perf_counter() - t_main})
    return counts


# ----------------------------------------------------------------- collab

#: gates D1-D6: the fleet's seed and its two model fleets' names
COLLAB_SEED = 28
COLLAB_FLEET = "collab"
COLLAB_SYNC_FLEET = "collab-sync"
#: minicpm-2b at full width with its depth cut to this many layers: two
#: workers' train states, a fresh init and the fetched tree on one card,
#: and the numpy outer state of both workers in one host
COLLAB_LAYERS = 4
#: two workers, two rounds of two inner steps each, B=1 per worker, S=2048
#: (the flash path), lr 1e-3 with no warmup
COLLAB_WORKERS = 2
COLLAB_ROUNDS = 2
COLLAB_INNER = 2
COLLAB_SEQ = 2048
COLLAB_LR = 1e-3
COLLAB_TOPK = 0.05
#: gate D1's bound on the contributions' bytes against dense fp32
COLLAB_WIRE_RATIO = 0.10
#: gate D4's served prompts and greedy steps
COLLAB_PROMPTS = [64, 12]
COLLAB_STEPS = 8
#: gate D5: trainer steps (each one published) and what the subscriber
#: follows to
COLLAB_SYNC_STEPS = 2
#: gate D2's constants: ``collab_golden`` over gate C1's fp32 tree and the
#: same tree drawn from seed + 1, computed through the JAX package on the
#: CPU and re-derived there by
#: ``tests/test_torch_collab.py::test_collab_golden_constants``
COLLAB_GOLDEN = {
    "parts_sha256": "908bd303cf28db0db1f77864d59bd35382db827a79bd38d2c4c9316"
                    "68ab0865f",
    "sent_digest": "0531dfdcda8509ee2d4b4e70b1eabdd37c281b049cbd3ddb80692692"
                   "670d4ebb",
    "outer_digest": "88048bb1f8db591d2d645acb17781515f53c423d7e71265a531e6f6"
                    "f21632028",
    "wire_bytes": 393742, "dense_bytes": 6296576}


def collab_golden(compress, outer_step, tree_a, tree_b) -> dict:
    """Gate D2's readings: ``tree_to_flat`` of both trees, the
    pseudo-gradient a - b, ``compress_pseudograd(frac=COLLAB_TOPK,
    quant="int8_block")``, then one Nesterov outer step on a's flat from
    zero momentum (outer lr 0.7, momentum 0.9) with the average of the one
    decoded contribution.  ``compress`` is either package's
    ``train.compress`` and ``outer_step`` its ``CollabWorker._outer_step``.
    Returns the sha256 over the parts' (name, payload, meta), each
    length-prefixed, the ``flat_digest`` of ``sent`` and of the outer
    params, and the stats."""
    import hashlib
    from types import SimpleNamespace

    import numpy as np

    start = compress.tree_to_flat(tree_a)
    grad = compress.pseudo_gradient(start, compress.tree_to_flat(tree_b))
    parts, sent, stats = compress.compress_pseudograd(
        grad, frac=COLLAB_TOPK, quant="int8_block")
    h = hashlib.sha256()
    for name, raw, meta in parts:
        for field in (name.encode("utf-8"), raw, meta):
            h.update(len(field).to_bytes(8, "big"))
            h.update(field)
    worker = SimpleNamespace(
        ccfg=SimpleNamespace(outer_lr=0.7, outer_momentum=0.9,
                             nesterov=True),
        outer_flat=dict(start),
        outer_mom={k: np.zeros_like(v) for k, v in start.items()})
    outer_step(worker, compress.average_flat([sent]))
    return {"parts_sha256": h.hexdigest(),
            "sent_digest": compress.flat_digest(sent),
            "outer_digest": compress.flat_digest(worker.outer_flat),
            "wire_bytes": stats["wire_bytes"],
            "dense_bytes": stats["dense_bytes"]}


def collab_nat_kinds(mesh):
    """The six peers' NAT specs: the two workers behind a port-restricted
    cone and a restricted cone NAT; gate D4's edge behind a symmetric NAT
    with random ports; gate D5's trainer behind a full cone NAT and its
    subscriber behind a symmetric NAT with sequential ports; the sixth
    behind no NAT."""
    kind, alloc = mesh.nat.NATKind, mesh.nat.PortAlloc
    return [kind.PORT_RESTRICTED, kind.RESTRICTED_CONE,
            (kind.SYMMETRIC, alloc.RANDOM, 1), kind.FULL_CONE,
            (kind.SYMMETRIC, alloc.SEQUENTIAL, 1), None]


def collab_fleet(mesh):
    """From ``fresh_counters``, ``make_fleet(6, ...)`` of the port's mesh
    (``collab_nat_kinds``) under ``Sim(seed=COLLAB_SEED)``."""
    fresh_counters(mesh)
    return mesh.fleet.make_fleet(6, nat_kinds=collab_nat_kinds(mesh),
                                 sim=mesh.simnet.Sim(seed=COLLAB_SEED))


def collab_workers(cfg, fleet, states):
    """One ``CollabWorker`` of the port per state, on peers 0, 1, ...,
    each on its shard of ``make_batch_iterator(vocab, COLLAB_SEQ,
    COLLAB_WORKERS, n_shards=COLLAB_WORKERS, shard=i, seed=0)``."""
    from repro_torch.data import make_batch_iterator
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import collab

    sched = cosine_schedule(COLLAB_LR, 0, 100)
    return [collab.CollabWorker(
        fleet.peers[i], cfg, state, sched, make_batch_iterator(
            cfg.vocab, COLLAB_SEQ, COLLAB_WORKERS,
            n_shards=COLLAB_WORKERS, shard=i, seed=0), COLLAB_FLEET,
        collab=collab.CollabConfig(
            inner_steps=COLLAB_INNER, settle=0.5, topk_frac=COLLAB_TOPK,
            quant="int8_block", keep_rounds=1), step_seconds=0.5)
        for i, state in enumerate(states)]


def collab_run(fleet, workers, rounds):
    """Every worker's ``run(rounds)`` as a sim process, to the last one's
    end; the fleet then runs on ``MESH_DRAIN_S`` simulated seconds.
    Returns each worker's rounds applied."""
    sim = fleet.sim
    procs = [sim.process(w.run(rounds)) for w in workers]

    def joined():
        return (yield sim.all_of(procs))
    applied = sim.run_process(joined(), until=sim.now + 3600)
    sim.run(until=sim.now + MESH_DRAIN_S)
    return applied


def _d3_ratios(runs, key):
    """T2's form per entry of ``runs[...]`` (name -> float64 tensor), with
    ``s`` the entry's largest |cpu64|: max|card32 - cpu64| / max(1e-4 s,
    2 max|cpu32 - cpu64|).  Returns (ratio, *key, name) tuples."""
    out = []
    for name in sorted(runs["cpu64"]):
        a, b, c = (runs[r][name] for r in ("card32", "cpu32", "cpu64"))
        scale = c.abs().max().item()
        require(scale > 0, f"D3: {key} {name}: all zero")
        err = (a - c).abs().max().item() / scale
        bound = max(1e-4, 2 * (b - c).abs().max().item() / scale)
        out.append((err / bound, *key, name))
    return out


def _recording(step_fn, log):
    """``step_fn`` with the gradient that each call clips appended to
    ``log`` (float64 CPU copies by leaf name), taken before the clip
    scales it in place: the gradients that the step's AdamW update used."""
    import torch

    from repro_torch.train import step as step_mod

    def run(state, batch):
        clip = step_mod.clip_by_global_norm

        def kept(grads, max_norm):
            log.append({n: g.detach().to("cpu", torch.float64, copy=True)
                        for n, g in named_leaves(grads, sep="/")})
            return clip(grads, max_norm)
        step_mod.clip_by_global_norm = kept
        try:
            return step_fn(state, batch)
        finally:
            step_mod.clip_by_global_norm = clip
    return run


def adamw_replay(torch, base, grads, dtype):
    """The collab workers' clip and AdamW update (max norm 1, decay 0.1,
    ``cosine_schedule(COLLAB_LR, 0, 100)``) applied on the CPU in numpy
    ``dtype`` to ``grads`` (one dict by leaf name per step) from the numpy
    tree ``base``: the pseudo-gradient, start minus end, by leaf name as
    float64 tensors (a float32 replay's rounded to float32, as
    ``pseudo_gradient`` rounds it)."""
    import numpy as np

    from repro_torch.optim import (adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule)
    from repro_torch.params import params_from_numpy
    from repro_torch.tree import unflatten

    params = params_from_numpy(_cast_tree(base, dtype), "cpu")
    names = [n for n, _ in named_leaves(params, sep="/")]
    opt = adamw_init(params)
    sched = cosine_schedule(COLLAB_LR, 0, 100)
    for g in grads:
        # copies: the clip scales its gradients in place
        clipped, _ = clip_by_global_norm(unflatten(params, [
            g[n].to(torch.float64 if dtype == np.float64 else torch.float32,
                    copy=True) for n in names]), 1.0)
        opt = adamw_update(params, clipped, opt, sched(opt.step),
                           weight_decay=0.1)
    start = dict(named_leaves(base, sep="/"))
    out = {}
    for name, t in named_leaves(params, sep="/"):
        d = torch.from_numpy(np.asarray(start[name], np.float64)) - t.double()
        out[name] = d.float().double() if dtype == np.float32 else d
    return out


def collab_round_runs(torch, cfg, runs, tf32=False):
    """One collab round of two workers (``cfg``, init seed ``COLLAB_SEED``,
    ``COLLAB_INNER`` steps at ``COLLAB_SEQ``) for each ``(name, device,
    numpy dtype)`` of ``runs``, on the same batches; with ``tf32``, TF32
    matmuls are allowed during the round.  Returns the numpy init and, by
    run name, its launch counts and per worker the gradients each step
    used (``_recording``) and the round's pseudo-gradient, start minus
    end, by leaf name as float64 tensors."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.optim import adamw_init
    from repro_torch.params import params_from_numpy, params_to_numpy
    from repro_torch.train import TrainState
    from repro_torch.train.compress import pseudo_gradient, tree_to_flat
    from repro_torch.tree import leaves

    base = params_to_numpy(decoder.init_params(
        cfg, torch.Generator().manual_seed(COLLAB_SEED), "cpu"))
    mesh = port_mesh()
    out = {}
    for name, dev, dt in runs:
        states = []
        for _ in range(COLLAB_WORKERS):
            params = params_from_numpy(_cast_tree(base, dt), dev)
            for p in leaves(params):
                p.requires_grad_(True)
            states.append(TrainState(params, adamw_init(params)))
        fleet = collab_fleet(mesh)
        workers = collab_workers(cfg, fleet, states)
        logs = [[] for _ in workers]
        for w, log in zip(workers, logs):
            w.step_fn = _recording(w.step_fn, log)
        start = {k: v.copy() for k, v in workers[0].outer_flat.items()}
        ops.reset_launch_counts()
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            closed = collab_run(fleet, workers, 1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
        require(closed == [1] * COLLAB_WORKERS,
                f"D3: a {name} worker did not close its round")
        pgs = []
        for w in workers:
            if dt == np.float64:
                end = dict(named_leaves(w._state.params, sep="/"))
                pgs.append({k: torch.from_numpy(v).double()
                            - end[k].detach().cpu() for k, v in start.items()})
            else:
                pgs.append({k: torch.from_numpy(v).double() for k, v in
                            pseudo_gradient(start, tree_to_flat(
                                w._state.params)).items()})
        out[name] = {"launches": ops.launch_counts(), "pg": pgs,
                     "grads": logs}
        del workers, fleet, states
    return base, out


def collab_parity(torch, cfg, device="cuda"):
    """Gate D3: two workers, one round of ``COLLAB_INNER`` steps at
    S=2048, from one init (``cfg``, seed ``COLLAB_SEED``) crossed to the
    card (``device``) in fp32 and to the CPU in fp32 and float64, on the
    same batches, each held in T2's form per leaf (``_d3_ratios``):

    * D3a, the gradients: each step's gradient before clipping, each run
      on its own trajectory, card32 against cpu32 and cpu64;
    * D3b, the update: the card's pseudo-gradient against the port's clip
      and AdamW replayed on the CPU in float64 on the card's own
      gradients, the same replay in float32 standing for cpu32.

    The round's pseudo-gradient is not compared across runs: AdamW divides
    each element's first moment by its own magnitude plus 1e-8, so the
    rounding of an element far below its leaf's largest moves that
    element's update by a share of the lr that no bound on the gradient's
    error limits.  D3a holds what the card computes before that division,
    D3b the division and the update.  On the card, the card run launches
    the flash forward and backward once per layer per step and the CPU
    runs never, and a control round on the card with TF32 matmuls allowed
    is read under D3a, where it must fail.  Returns the readings; the
    caller holds them."""
    import numpy as np

    runs = [("card32", device, np.float32), ("cpu32", "cpu", np.float32),
            ("cpu64", "cpu", np.float64)]
    base, got = collab_round_runs(torch, cfg, runs)
    if device == "cuda":
        want = {k: 0 for k in got["card32"]["launches"]}
        want["flash_attention"] = want["flash_attention_bwd"] = (
            cfg.n_layers * COLLAB_INNER * COLLAB_WORKERS)
        require(got["card32"]["launches"] == want, f"D3: card launches "
                f"{got['card32']['launches']} != {want}")
        require(not any(got["cpu32"]["launches"].values())
                and not any(got["cpu64"]["launches"].values()),
                "D3: the CPU runs launched kernels")

    def grad_ratios(card):
        rows = []
        for i in range(COLLAB_WORKERS):
            for k in range(COLLAB_INNER):
                rows += _d3_ratios({
                    "card32": card["grads"][i][k],
                    "cpu32": got["cpu32"]["grads"][i][k],
                    "cpu64": got["cpu64"]["grads"][i][k]}, (i, k))
        return rows

    def reading(rows):
        worst = max(rows)
        return {"ratio_to_bound_max": worst[0], "worst": list(worst[1:]),
                "over_bound": [list(r) for r in sorted(rows, reverse=True)
                               if r[0] > 1.0], "readings": len(rows)}

    update = []
    for i in range(COLLAB_WORKERS):
        shared = got["card32"]["grads"][i]
        update += _d3_ratios({
            "card32": got["card32"]["pg"][i],
            "cpu32": adamw_replay(torch, base, shared, np.float32),
            "cpu64": adamw_replay(torch, base, shared, np.float64)}, (i,))
    out = {"config": f"minicpm-2b reduced(L={cfg.n_layers}, "
                     f"d={cfg.d_model}, vocab={cfg.vocab})",
           "grads": reading(grad_ratios(got["card32"])),
           "update": reading(update),
           "launches": {r: g["launches"] for r, g in got.items()}}
    if device == "cuda":
        _, ctl = collab_round_runs(torch, cfg, runs[:1], tf32=True)
        control = reading(grad_ratios(ctl["card32"]))
        control["over_bound"] = len(control["over_bound"])
        out["control_tf32"] = control
    return out


def collab_parity_holds(d3) -> None:
    """Gate D3's verdict on ``collab_parity``'s readings."""
    for part in ("grads", "update"):
        r = d3[part]
        require(r["ratio_to_bound_max"] <= 1.0, f"gate D3 fails: {part} "
                f"{r['worst']} at {r['ratio_to_bound_max']} of its bound")
    if "control_tf32" in d3:
        r = d3["control_tf32"]
        require(r["ratio_to_bound_max"] > 1.0, "D3's control passed: the "
                f"TF32 round read {r['ratio_to_bound_max']} of D3a's bound")


def collab_phase(torch, t_main, device="cuda", cfg=None, parity_cfg=None):
    """Gates D1-D6: DiLoCo rounds of the port's ``CollabWorker`` on the
    card, then the paper's RL pipeline: the outer params published over
    the port's mesh, fetched onto the card behind a symmetric NAT and
    served; and a ``LatticaSyncTrainer`` followed by a ``ModelSubscriber``.
    ``cfg`` is minicpm-2b at full width cut to ``COLLAB_LAYERS`` layers by
    default, ``parity_cfg`` gate D3's reduced one (``T2_REDUCED``);
    ``device`` is the card's, and a CPU rehearsal passes ``"cpu"`` and
    small configs."""
    from repro_torch.checkpoint import (CheckpointRegistry,
                                        fetch_latest_from,
                                        publish_checkpoint, serve_checkpoints)
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.models import decoder
    from repro_torch.optim import cosine_schedule
    from repro_torch.params import params_from_numpy
    from repro_torch.train import (LatticaSyncTrainer, collab, compress,
                                   train_state_init)
    from repro_torch.train.trainer import ModelSubscriber

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    full = get_config("minicpm-2b")
    cfg = cfg or dataclasses.replace(full, n_layers=COLLAB_LAYERS)
    parity_cfg = parity_cfg or full.reduced(**T2_REDUCED)
    L = cfg.n_layers
    mesh = port_mesh()
    stages = {}

    def card_peak():
        if not on_card:
            return None
        out = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return out

    def freed():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def only(counts, want, gate):
        full_want = {k: 0 for k in counts}
        full_want.update(want)
        require(counts == full_want, f"{gate}: launches {counts} != "
                f"{full_want}")

    # D2: the outer math on card-held trees, exact
    tree_a = golden_trees(torch, device)["fp32"]
    tree_b = params_from_numpy(golden_numpy_tree(
        tree_a, CKPT_GOLDEN_SEED + 1), device)
    d2 = collab_golden(compress, collab.CollabWorker._outer_step, tree_a,
                       tree_b)
    require(d2 == COLLAB_GOLDEN, f"D2: {d2} != {COLLAB_GOLDEN}")
    del tree_a, tree_b

    # D1: the rounds at full width
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fleet = collab_fleet(mesh)
    sim = fleet.sim
    sim.leak_baseline()
    workers = collab_workers(cfg, fleet, [train_state_init(
        cfg, torch.Generator(device=device).manual_seed(COLLAB_SEED), device)
        for _ in range(COLLAB_WORKERS)])
    ops.reset_launch_counts()
    t_sim = sim.now
    d1_calls = {}
    timed = [(collab, n) for n in (
        "tree_to_flat", "pseudo_gradient", "compress_pseudograd",
        "flat_from_entries", "average_flat")]
    timed += [(collab.CollabWorker, "_outer_step")]
    timed += [(w, "step_fn") for w in workers]
    with call_seconds(d1_calls, timed,
                      torch.cuda.synchronize if on_card else None):
        applied = _rss_stage(stages, "d1", lambda: collab_run(
            fleet, workers, COLLAB_ROUNDS))
    d1_calls["rest"] = {"s": stages["d1"]["s"] - sum(
        v["s"] for v in d1_calls.values())}
    d1_sim_s = sim.now - t_sim
    d1_counts = ops.launch_counts()
    require(applied == [COLLAB_ROUNDS] * COLLAB_WORKERS
            and all(w.outer_round == COLLAB_ROUNDS for w in workers),
            f"D1: rounds applied {applied}, outer rounds "
            f"{[w.outer_round for w in workers]}")
    require(all(w.stats["rounds_aborted"] == w.stats["rounds_degraded"] == 0
                for w in workers), f"D1: {[w.stats for w in workers]}")
    digests = sorted({w.outer_digest() for w in workers})
    require(len(digests) == 1, f"D1: outer state forked: {digests}")
    ratios = [w.stats["wire_bytes"] / w.stats["dense_bytes"]
              for w in workers]
    require(max(ratios) <= COLLAB_WIRE_RATIO, f"D1: wire ratios {ratios}")
    require(all(w.overdue_pins() == 0 for w in workers),
            f"D1: overdue pins {[w.overdue_pins() for w in workers]}")
    hist = [h for w in workers for h in w.history]
    taken = COLLAB_WORKERS * COLLAB_ROUNDS * COLLAB_INNER
    require(len(hist) == taken and all(
        math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
        for h in hist), f"D1: inner steps {hist}")
    only(d1_counts, {"flash_attention": L * taken,
                     "flash_attention_bwd": L * taken}, "D6 in D1")
    d1_held = sim.leak_audit()
    n_params = sum(v.size for v in workers[0].outer_flat.values())
    d1_peak = card_peak()

    # D4: the lead publishes the outer params, an edge behind a symmetric
    # NAT fetches them onto the card, and both trees serve alike
    lead, edge = workers[0], fleet.peers[2]
    outer = lead.outer_params()
    sim.leak_baseline()
    serve_checkpoints(lead.node)

    def publish():
        return (yield from publish_checkpoint(lead.node, outer, COLLAB_ROUNDS,
                                              COLLAB_FLEET))

    def fetch():
        t0 = sim.now
        step, got = yield from fetch_latest_from(
            edge, lead.node.info(), COLLAB_FLEET, like=decoder.init_params(
                cfg, torch.Generator(device=device).manual_seed(1), device))
        return step, got, sim.now - t0
    root = _rss_stage(stages, "d4_publish", lambda: sim.run_process(
        publish()))
    step, fetched, d4_fetch_sim_s = _rss_stage(
        stages, "d4_fetch", lambda: sim.run_process(fetch()))
    latest = CheckpointRegistry(lead.node, COLLAB_FLEET).latest()
    require(latest == (COLLAB_ROUNDS, root) and step == latest[0],
            f"D4: fetched step {step}, registry {latest}")
    want = dict(named_leaves(outer))
    got = dict(named_leaves(fetched))
    require(sorted(got) == sorted(want), "D4: other leaves came back")
    for name, b in got.items():
        require(b.device.type == device and torch.equal(want[name], b),
                f"D4: {name} differs or is not on the card")
    conn = edge.host.connection_to(lead.node.host)
    d4_path = ("none" if conn is None else "relayed" if conn.relayed
               else "direct")
    for node in (lead.node, edge):
        node.unpin_latest(f"ckpt/{COLLAB_FLEET}")
    for c in list(edge.host._connections.get(lead.node.host.name, [])):
        c.close()
    # D1's fetches left half-open streams (a reference hazard); closing
    # their connections may take gauges below this baseline, never above
    d4_leaks = sim.leak_audit()
    require(all(v < 0 for v in d4_leaks.values()),
            f"D4: leak audit {d4_leaks}")
    d4_counts, d4_tokens, _ = _rss_stage(stages, "d4_serve", lambda:
                                         same_served_tokens(
        torch, cfg, outer, fetched, "D4", device, lengths=COLLAB_PROMPTS,
        steps=COLLAB_STEPS))
    only(d4_counts, {"paged_decode_attention": L * COLLAB_STEPS},
         "D6 in D4")
    d4_peak = card_peak()
    d1_stats = [dict(w.stats, name=w.name) for w in workers]
    d1_rounds = [[h["loss"] for h in w.history] for w in workers]
    nat = {n.host.name: fleet.nat_kind_of(n) for n in fleet.peers}
    del workers, lead, edge, outer, fetched, want, got, fleet, sim, conn
    freed()

    # D5: a LatticaSyncTrainer publishes every step; a ModelSubscriber
    # behind a symmetric NAT follows it onto the card
    fleet = collab_fleet(mesh)
    sim = fleet.sim
    trainer_node, sub_node = fleet.peers[3], fleet.peers[4]
    trainer = LatticaSyncTrainer(
        cfg, train_state_init(cfg, torch.Generator(device=device).manual_seed(
            COLLAB_SEED), device), cosine_schedule(COLLAB_LR, 0, 100),
        make_batch_iterator(cfg.vocab, COLLAB_SEQ, 1, seed=0),
        node=trainer_node, fleet=COLLAB_SYNC_FLEET, publish_every=1,
        step_seconds=0.5)
    sub = ModelSubscriber(sub_node, cfg, COLLAB_SYNC_FLEET,
                          like=decoder.init_params(
                              cfg, torch.Generator(device=device).manual_seed(
                                  1), device))
    ops.reset_launch_counts()
    procs = [sim.process(trainer.run_mesh(COLLAB_SYNC_STEPS, log=None)),
             sim.process(sub.follow(interval=2.0,
                                    until_step=COLLAB_SYNC_STEPS))]

    def joined():
        return (yield sim.all_of(procs))
    _rss_stage(stages, "d5", lambda: sim.run_process(
        joined(), until=sim.now + 7200))
    d5_counts = ops.launch_counts()
    require(sub.current_step == COLLAB_SYNC_STEPS,
            f"D5: the subscriber reached step {sub.current_step}")
    want = dict(named_leaves(trainer.state.params))
    got = dict(named_leaves(sub.params))
    require(sorted(got) == sorted(want), "D5: other leaves came back")
    for name, b in got.items():
        require(b.device.type == device and torch.equal(
            want[name].detach(), b), f"D5: {name} differs or is not on the "
            "card")
    registries = [CheckpointRegistry(n, COLLAB_SYNC_FLEET).latest()
                  for n in (sub_node, trainer_node)]
    require(registries[0] == registries[1] is not None,
            f"D5: registries {registries}")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in trainer.history), f"D5: {trainer.history}")
    only(d5_counts, {"flash_attention": L * COLLAB_SYNC_STEPS,
                     "flash_attention_bwd": L * COLLAB_SYNC_STEPS},
         "D6 in D5")
    d5_peak = card_peak()
    d5 = {"fetch_log": sub.fetch_log, "sim_s": sim.now,
          "loss": [h["loss"] for h in trainer.history],
          "published": len(trainer.published)}
    del trainer, sub, want, got, fleet, sim, procs
    freed()

    # D3: a reduced round, card against the CPU, read last and held after
    # the line, so that the line carries every gate's readings
    d3 = _rss_stage(stages, "d3", lambda: collab_parity(
        torch, parity_cfg, device))
    emit({"phase": "collab", "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": nvidia_smi(), "model": cfg.name,
          "reduced": {"n_layers": [full.n_layers, L]},
          "params": n_params,
          "d1": {"digest": digests[0], "wire_ratio": ratios,
                 "stats": d1_stats, "inner_loss": d1_rounds,
                 "sim_s": d1_sim_s, "leaks_held": d1_held, "nat": nat,
                 "calls": d1_calls},
          "d2": d2, "d3": d3,
          "d4": {"root": cid_hex(root), "path": d4_path,
                 "leaks": d4_leaks,
                 "fetch_sim_s": d4_fetch_sim_s, "tokens": d4_tokens},
          "d5": d5,
          "launches": {"d1": d1_counts, "d4": d4_counts, "d5": d5_counts},
          "wall_s": {k: v["s"] for k, v in stages.items()},
          "peak_rss_bytes": {k: v["peak_rss_bytes"]
                             for k, v in stages.items()},
          "max_memory_allocated_bytes": {"d1": d1_peak, "d4": d4_peak,
                                         "d5": d5_peak},
          "smoke_s": time.perf_counter() - t_main})
    collab_parity_holds(d3)
    return d1_counts


def trim_host() -> None:
    """Hand the heap's freed pages back to the system (glibc
    ``malloc_trim``): the mesh phases free gigabytes in 256 KiB blocks that
    the process would otherwise keep, and the collab phase's numpy outer
    state needs that host memory."""
    import ctypes

    ctypes.CDLL("libc.so.6").malloc_trim(0)


def release(torch, before: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    require(held < 2 ** 30, f"{held} bytes still allocated before {before}")


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.kernels import build

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "spill" in ln] for k, v in logs.items()}})

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB
    paged = paged_phase(torch, flush, logs.get("paged_attention", ""))
    flash = flash_phase(torch, flush, logs.get("flash_attention", ""))
    flash_bwd = flash_backward_phase(torch, flush,
                                     logs.get("flash_attention_bwd", ""))
    gating_phase(torch, flush)
    router = router_gating_phase(torch, flush, logs.get("moe_gating", ""))
    router_bwd = router_gating_backward_phase(
        torch, flush, logs.get("moe_gating_bwd", ""))
    mlstm = mlstm_phase(torch, flush, logs.get("mlstm_scan", ""))
    mlstm_backward_phase(torch, flush)
    del flush
    small_parity_phase(torch)
    xlstm_parity_phase(torch)
    hybrid_parity_phase(torch)
    vlm_parity_phase(torch)
    audio_parity_phase(torch)
    train_parity_phase(torch)
    moe_train_parity_phase(torch)
    with spawn_pool() as pool:
        # gates T2h, T2v, T2a and T2x: their CPU runs go to a worker while
        # the card serves (host-bound on one core); the card runs come after
        t2 = {arch: t2_inputs(torch, arch) for arch in T2_ARCHS}
        threads = max(1, (os.cpu_count() or 2) // 2)
        t2_cpu = {arch: pool.apply_async(t2_cpu_runs, (*t2[arch], threads))
                  for arch in T2_ARCHS}
        counts = serving_phase(torch, "granite-8b", "serving")
        # granite-8b's 33 GB, qwen2-moe-a2.7b's 57 GB and xlstm-1.3b's 23
        # GB do not fit one card together: everything of one model must
        # be gone before the next
        release(torch, "serving_moe")
        moe_counts = serving_phase(torch, "qwen2-moe-a2.7b", "serving_moe")
        release(torch, "serving_xlstm")
        xlstm_counts = serving_xlstm_phase(torch)
        release(torch, "serving_hybrid")
        serving_hybrid_phase(torch)
        release(torch, "serving_vlm")
        serving_vlm_phase(torch)
        release(torch, "serving_audio")
        serving_audio_phase(torch)
        release(torch, "the T2h, T2v, T2a and T2x card runs")
        for arch in T2_ARCHS:
            # the worker's runs take ~3 minutes and started ~5 before: a
            # worker that died leaves its result unset, so wait no longer
            arch_train_parity_phase(torch, arch,
                                    cpu_runs=t2_cpu[arch].get(timeout=300))
    release(torch, "training")
    train_counts, _ = training_phase(torch)
    release(torch, "moe_training")
    moe_train_counts, _ = moe_training_phase(torch)
    for arch in T3_ARCHS:
        release(torch, T3_ARCHS[arch][0])
        arch_training_phase(torch, arch)
    release(torch, "checkpoint")
    with cut_depth("minicpm-2b", CKPT_LAYERS):
        trained, trained_entries = checkpoint_phase(torch)
        fetched, reference = mesh_phase(torch, trained, trained_entries,
                                        t_main)
        # the fleet serves the fetched tree: the trained one goes first
        del trained, trained_entries
        gc.collect()
        torch.cuda.empty_cache()
        fleet_phase(torch, fetched, reference, t_main)
        del fetched, reference
    gc.collect()
    torch.cuda.empty_cache()
    trim_host()
    collab_phase(torch, t_main)
    emit({"phase": "done", "seconds": time.perf_counter() - t_main})

    emit({"kernels": [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:116",
         "launches": counts["paged_decode_attention"],
         "max_abs_err": max(paged["max_abs_err"].values()),
         "ms": paged["kernel_ms"], "plain_ms": paged["plain_ms"],
         "bound_ms": paged["bound_ms"], "bound_by": "bytes",
         "library_ms": paged["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:30",
         "launches": counts["flash_attention"],
         "max_abs_err": flash["max_abs_err_fp32"],
         "ms": flash["kernel_ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         # no TPU kernel: the JAX gradient of attention is the jnp VJP
         "replaces": "src/repro/models/chunked.py:86",
         "launches": train_counts["flash_attention_bwd"],
         # at the main path's shape: minicpm-2b, B=1, H=36, S=2048, hd=64
         "max_abs_err": flash_bwd["max_abs_err_minicpm"],
         "ms": flash_bwd["minicpm"]["kernel_ms"],
         "plain_ms": flash_bwd["minicpm"]["plain_ms"],
         "bound_ms": flash_bwd["minicpm"]["bound_ms"],
         "bound_by": flash_bwd["minicpm"]["bound_by"],
         "library_ms": flash_bwd["minicpm"]["library_ms"]},
        {"name": "moe_gating", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
         "entry": "router_gating_cuda (kernels/moe_gating.py)",
         "replaces": "src/repro/kernels/moe_gating.py:22 + "
                     "src/repro/models/moe.py:90",
         "launches": moe_counts["moe_gating"],
         "max_abs_err": router["max_abs_err"],
         # times at T=8 (cold L2 by a rewrite), the decode step that makes
         # most of the launches
         "ms": router["T8"]["kernel_ms"]["rewrite"],
         "plain_ms": router["T8"]["plain_ms"],
         "bound_ms": router["T8"]["bound_ms"],
         "bound_by": router["T8"]["bound_by"],
         "library_ms": router["library_ms"]},
        {"name": "moe_gating_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gating_bwd.cu",
         "entry": "router_gating_bwd_cuda (kernels/moe_gating.py)",
         # no TPU kernel: the JAX gradient of the gating is XLA's autodiff
         # of the jnp topk_gating
         "replaces": "src/repro/models/moe.py:62",
         "launches": moe_train_counts["moe_gating_bwd"],
         # at the main path's shape: one micro-batch of qwen2-moe-a2.7b's
         # training, T=2048, E=60, K=4 (the kernel's dlogits)
         "max_abs_err": router_bwd["max_abs_err_dlogits_T2048"],
         "ms": router_bwd["T2048"]["kernel_ms"],
         "plain_ms": router_bwd["T2048"]["plain_ms"],
         "bound_ms": router_bwd["T2048"]["bound_ms"],
         "bound_by": router_bwd["T2048"]["bound_by"],
         "library_ms": router_bwd["library_ms"]},
        {"name": "mlstm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
         "replaces": "src/repro/kernels/mlstm_scan.py:25",
         "launches": xlstm_counts["mlstm_scan"],
         # at the main path's long prompt: B=1, H=4, S=2048, hd=1024
         "max_abs_err": mlstm["S2048_cache"]["h_abs"],
         "ms": mlstm["S2048_cache"]["kernel_ms"],
         "plain_ms": mlstm["S2048_cache"]["plain_ms"],
         "bound_ms": mlstm["S2048_cache"]["bound_ms"],
         "bound_by": mlstm["S2048_cache"]["bound_by"],
         "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
