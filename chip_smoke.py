"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero, with no result line):
  1. device   - require CUDA; print nvidia-smi's name and power limit.
  2. build    - build the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels  - run every kernel at the ResNet-20 main paths' shapes on the
                card and hold it bit-identical (tolerance 0) to its plain
                PyTorch version on the same inputs; time both with CUDA
                events (median of 20 after warm-up), and the kernels alone
                with torch.profiler.  K1 at the stage-1 forward and
                weight-gradient operands, four groupings, <2,4> and <2,1>.
                K3 at the weight gradients of all three stages, the
                stage-1 and stage-3 forwards, the stage-3 data gradient, a
                ragged shape and k_block 144, four groupings, on the plan
                matmul_plan picks and on every other variant it accepts
                (k3_plans: walk, ordered split, wgmma where k_block is a
                multiple of 128); <3,1> on the int32 body.  K2 ("c", "none") also at
                the implicit "none" path's (N*C*Hp, Wp) = (69632, 34)
                operand, its code pass alone there, and an all-zero
                operand.  The implicit conv (K4) runs at its stage-1,
                stage-2 (stride 2) and stage-3 convs, four groupings (the
                scales of every grouping made by K4's own passes),
                <2,4> and <2,1>, <3,1> (int32 body) at stage 1, and at two
                zoo convs the dispatch sends to it at k_block 128
                (GoogleNet's 3b 1x1, ResNet-18's stride-2 projection); it
                is held to the im2col route too and timed beside it ("c"
                and "n" also beside the PyTorch glue that made their
                scales before).  K1 ("nc", "n") on both operands and K3
                (every plan) of the three GEMMs of four zoo convs at the
                zoo phase's shapes (ZOO_CONVS: ResNet-18's stage-1 3x3,
                ResNet-34's stage-4 3x3, GoogleNet's 4b 3x3, VGG-16's
                last 3x3).  K1 ("nc", "n") and K4 (four groupings) with a
                NaN input against the plain versions on the CPU.
  3b. tune    - the tile cache (repro_torch.kernels.autotune): the committed
                seed cache's --check on the card (every path and registry
                spec cached, every winner proven with the built library's
                constants); every cached winner's output bit-identical to
                its default's and to the plain version at its spec's shape;
                --tune --force of one gemm, one quantize and one conv spec
                (TUNE_FORCE) into chiprun_out/kernel_tune_forced.json,
                candidates timed and pruned; benchmarks/torch_kernel_bench.py
                into chiprun_out/BENCH_torch_kernels.json; one full-width
                ResNet-20 main-path step with the seed cache and one with an
                empty cache: loss and gradients equal bit for bit, 120 K1 /
                60 K3 launches each, both step times printed.  The phases
                after it resolve through the seed cache where it was tuned
                on this card (its conv choices can move a k_block-144 conv
                from K4 to im2col: expected_launches follows the dispatch).
  4. train    - the main path: 5 SGD steps of ResNet-20 at full width
                (CIFAR 32x32, batch 128, <2,4>, k_block 128, grouping "nc",
                stochastic rounding) through repro_torch.train; losses must
                be finite and every step must launch the quantize kernel
                120 times and the GEMM kernel 60 times (20 quantized convs x
                6 operands / x 3 GEMMs), and K4 never (no conv is legal
                for it at k_block 128).  Then 2 steps with grouping "c"
                (paper Table IV), the path of the given-scale kernel.  Then
                the implicit path: 5 steps at k_block 144 (cb = 16 channels
                x 3x3 taps), where the 18 3x3 convs run their forward
                through K4; then 2 steps of it with grouping "none" and
                nearest rounding (K4's given-scale prologue and the weight
                gradient that reuses the forward codes).  Each path's
                launches per step must equal what the dispatch gives for
                its 20 convs (expected_launches).
  5. trace    - 3 more steps of the main path, the implicit path and the
                grouping-"c" path under torch.profiler: device time by
                kernel and the device's idle share of the step.
  6. agree    - a small ResNet-20 train step on the card (kernels) agrees
                with the same step on the CPU (plain versions), at k_block
                32 (im2col) and at k_block 36 (every 3x3 conv implicit).
  7. audit    - the verifier's planted-overlap control K5 against its plain
                version: the blocks no program writes stay NaN, each element
                of a twice-written block is bit-identical to one of its two
                writers' ordered fp32 sums (the race picks which), and the
                store probe counts [2, 0, 2, 0] by block column, the table
                the verifier derives from K5's launch spec; timed.  Then,
                in six worker processes side by side,
                `python -m repro_torch.analysis.audit --graph train
                --kernels --gate` at full width (one step at k_block 128,
                one at 144): it must pass, with quantized fraction >= 0.99
                on both paths and every recorded launch spec of K1-K4
                proven; `--graph serve --kernels --gate` (one quantized
                decode step of qwen2-72b's smoke config, batch 4, cache
                128): it must pass at the closed form's fraction 0.619048
                with its 42 launches proven; and each of the four
                --sabotage modes must fail the gate naming its violation
                (overlap_write runs K5 once).
  8. zoo      - VGG-16 and GoogleNet (CIFAR: 32x32, 10 classes, batch 128)
                and ResNet-18/34 (ImageNet: 224x224, 1000 classes, batch
                64) at full width on the quantized backend (<2,4>, k_block
                128, "nc", stochastic): 2 steps each with finite losses
                and each step's launches equal to the dispatch's count over
                the model's quantized convs as OpTrace lists them (K1 and
                K3 on all, K4 on the 1x1 convs with 128 | C); step time,
                peak device memory and one traced step.
  9. fake_quant - the fake-quant backend: 5 steps of full-width ResNet-20,
                batch 128, <2,1>, on the card, with finite losses and no
                launch of the port's kernels (the JAX package runs this
                path without Pallas: the quantizer is PyTorch code, the
                convs fp32 convs); a traced step; a small step on the card
                that agrees with the CPU.
  10. driver  - examples/torch_train_cifar_lowbit.py for 3 full-width steps
                (fp32, <2,4>, <2,1>, quantized backend); a checkpoint saved
                on the card and restored on the card and on the CPU, every
                tensor equal; the run resumed from it takes the next step
                with the uninterrupted run's loss.
  11. serve   - the LM serving path through repro_torch.serve.ServeEngine
                on the quantized kernels (quant_backend "pallas": K1 on
                both operands of every linear, then K3; nearest rounding),
                random weights, bf16 compute, batch 4 and 16 new tokens:
                chatglm3-6b at full width and depth (6.24 G fp32
                parameters, 128-token prompts), mamba2-370m at full width
                and depth (320-token prompts: SSD chunk 160 by the divisor
                rule), zamba2-7b at full width cut to 12 layers with a
                window of 136 (the ring buffer wraps), the MoEs at full
                width, moonshot-v1-16b-a3b cut to 4 layers (64 experts,
                top 6: tokens drop at prefill's capacity 13) and
                llama4-scout-17b-a16e to 2 (top 1 and a shared expert),
                and seamless-m4t-medium at full width and depth (its
                encoder over 1024 random frontend frames per prompt).
                Every logit finite; the launches of a whole generate, and
                of each prefill and decode step, equal the closed form
                (serve_linears: 196 K3 / 392 K1 per step on chatglm3-6b,
                96 / 192 on mamba2-370m, 38 / 76 on the cut zamba2-7b, 16
                / 32 on the cut moonshot (attention only: the routed
                experts run fake-quant GEMMs, as in the JAX package), 14 /
                28 on the cut llama4-scout, 96 / 192 per decode step and
                168 / 336 per prefill on seamless); prefill ms, decode ms
                per step (median) and tokens/s, one decode step traced
                (device busy, idle share, K1 and K3 ms, the routed experts'
                fake-quant ms), peak memory.  K1 and K3 (every plan) held
                bit-identical to their plain versions at the serving GEMMs
                (serve_gemms: SERVE_GEMMS and the new models' distinct
                shapes at decode and prefill) and the decode ones timed;
                what re-coding chatglm3-6b's weights costs per step
                (qd_gemm's transposed copy, the rounding-byte fill, K1),
                timed; the smoke configs of the six models on the card
                against the CPU (logits within 1e-3 of max(1,
                max|logit|), greedy tokens equal, launches the closed
                form).
  12. lm_train - LM training through repro_torch.train.make_train_step on
                the quantized kernels (quant_backend "pallas": K1 on both
                operands and K3 for the forward, data-gradient and
                weight-gradient GEMM of every linear, and once more for the
                forward that full remat recomputes), stochastic rounding,
                AdamW with the default cosine schedule, random weights, bf16
                compute, 4 steps each: chatglm3-6b at full width cut to 4 of
                its 28 layers at batch 2 x 4096 (train_4k's sequence),
                mamba2-370m at full width and depth at batch 4 x 1024,
                zamba2-7b at full width cut to 12 layers at batch 2 x 4096
                (the shared block runs twice, not remat'd),
                moonshot-v1-16b-a3b at full width cut to 2 layers at batch
                1 x 4096, and seamless-m4t-medium at full width cut to 6 +
                6 layers at batch 2 x 4096 over 4096 source frames.  Losses and grad
                norms finite; the weights unchanged by step 1 (lr 0) and
                moved by step 2; the launches of each step and of the run
                equal the closed form (lm_train_launches: 112 K3 / 224 K1
                per step on chatglm3-6b, 384 / 768 on mamba2-370m, 138 /
                276 on the cut zamba2-7b, 32 / 64 on the cut moonshot,
                384 / 768 on seamless); one step traced (device busy,
                idle share, K1, K3, copies, the routed experts'
                fake-quant), peak memory, the attention, the LM head and
                an MoE layer's experts timed alone at the step's shapes;
                a microbatch-2
                step on chatglm3-6b (finite, twice the launches), and one
                lm_loss forward and backward of it under remat "full" and
                under "dots" (loss and gradient norm equal bit for bit; ms
                and peak memory of each);
                mamba2-370m checkpointed after step 2 on the card, restored
                on the card, its step 3 bit-identical to the uninterrupted
                one.  K1 (stochastic, given bytes) and K3 (every plan it
                accepts: walk, ordered split, wgmma) bit-identical to
                their plain versions at every distinct
                training GEMM of the five models (forward, data and weight
                gradient of each quantized linear at the run's T:
                lm_train_gemms), chatglm3-6b's nine timed on every plan and
                beside torch._int_mm on the decoded int8 operands (the
                int8 dot alone, not K3's function), with the weight
                gradient's transposed copies; K3's launches of each run by
                plan variant, chatglm3-6b's and zamba2-7b's required to
                include the wgmma variant; each step's time
                is train_step alone, its batch drawn and timed before it;
                the smoke configs' lm_loss and gradients
                (key None) on the card against the CPU (LM_TRAIN_AGREE),
                as run and with every quantizer fed the CPU run's
                operands (fed_operands).
  12b. dryrun - the dry run (repro_torch.launch.dryrun) on fake cuda
                tensors.  Calibration: each lm_train model (its cut, batch
                and quant_backend "pallas") traced unsharded: K1 and K3
                per step (recorded by their shape-only path on fake
                operands) equal to lm_train_launches, and the predicted
                step peak, plus the tensors the lm_train run held beside
                its steps (watched weights' copies, the checkpointed
                model's), within 5% of the peak that run measured over its
                4 steps (max_memory_allocated; the models are not run
                again); each ratio printed with nvidia-smi's line.  Then
                run_cell (a fake process group of 256 / 512 ranks, the
                launcher's tensor-parallel + FSDP2 layout, rank 0 traced)
                on chatglm3-6b at 16x16 and moonshot-v1-16b-a3b at
                2x16x16, train_4k at full depth, and chatglm3-6b's
                prefill_32k and decode_32k at 16x16 (serving under the
                model axis: each rank's cache, DRYRUN_SERVE_CELLS), each
                serve cell traced on fake cuda and on fake cpu tensors
                and its two records equal but for lower_s: records
                printed and written to chiprun_out/torch_dryrun/.  The
                serve phase's chatglm3-6b decode (batch 4, its cache)
                traced unsharded: launches the closed form and its
                predicted peak within 5% of the serve phase's measured
                max_memory_allocated.  The twelve traces run side by side
                in worker processes, none of which launches a kernel
                (their counts stay 0); the card's
                total_memory printed beside the modelled card's
                (roofline.HBM_BYTES, which fits reads).  Then
                chatglm3-6b cut to 1 layer, K1/K3, batch 2 x 4096, one
                step for real on the card under the dry run's counter: its
                peak (with the counter's model of ops' own scratch,
                trace_counts.workspace_bytes) within 2% of
                max_memory_allocated over the step.
  13. sweep   - the frontier sweep's chip grid (repro_torch.sweep.chip_grid:
                ResNet-20 at full width, CIFAR 32x32, batch 128, lr 0.05,
                40 SGD-momentum steps; fp32, <2,4>, <2,1> and <0,4> on
                fake_quant; <2,4> and <2,1> on the kernels ("pallas": K1/K3,
                120 / 60 launches a step); <2,1> on the kernels with
                grouping "c" and "none" (K2/K3)), through
                repro_torch.sweep.runner; finite losses, every step's
                launches the dispatch's count (none on fake_quant), step
                times (median of steps 2-40) and the frontier table; the
                gate against the committed chip entries of
                src/repro_torch/sweep/baselines/accuracy.json must pass and
                fail under both sabotage modes ("regress", "missing_cell");
                two cells run again must repeat their losses bit for bit
                (and the fp32 cell twice with cuDNN's default algorithms,
                reported); then
                benchmarks/torch_table2_accuracy.py (quick) on the card,
                every variant's loss finite.
  14. parallel - the parallel slice.  The main path (counts set to 0 just
                before, read just after): parallel.compress of chatglm3-6b's
                w_up weight gradient (4096 x 13696 = 56.1 M elements, rows
                (438272, 128)) on K1, then the launcher's HSDP wrapping
                (launch.train.shard_model: FSDP2 over a 1x1x1 ("pod",
                "data", "model") mesh, NCCL, world 1) of mamba2-370m at
                full width, 2 steps at 4 x 1024 on K1/K3, each equal bit
                for bit (loss, grad norm, then every parameter) to the
                unwrapped make_train_step's, launches the closed form.
                compress held bit for bit to its plain version at nearest
                (K1 reading no byte) and with rounding bytes, both timed
                (CUDA events, and K1's kernels alone) beside the byte
                bound; the compressed ring in two processes on cuda:0 over
                gloo (the payload staged through the host) equal bit for
                bit to the in-process ordered sum, with exactly the ideal
                wire bytes (no multi-card time: one card); K4's emit path
                (emit_codes) at stage 1 "nc" bit for bit against im2col ->
                K1 and its y against the default path, both timed; the
                audit's wire section (analysis.wire.audit_wire_ring).
                The wire path (its launches set to 0 in each rank just
                before, read just after): the launcher's FSDP wire formats
                (launch.train.shard_model, parallel.fsdp_wire) in two
                processes on cuda:0 over gloo, mamba2-370m at full width
                (12 of 48 layers), 2 x 1024 a rank, 2 steps: the 2-byte gather
                (param_gather_dtype "bfloat16") on K1/K3 within 1e-6 of one
                process taking the ranks' slices as two microbatches, K1/K3
                launches the closed form; the 1-byte gather (packed_wire,
                fake-quant) equal bit for bit to the unpacked step (loss,
                every gradient, the parameters after 2 steps); one step's
                all-gathers counted by trace_counts.StepCounter, 1 B an
                element and 4 B a group of each pinned weight a use, the
                fp32 gathers less the pinned masters', the closed form.
                Then, in the wire path's two processes, the placement
                path: the launcher's FSDP2 placement
                (launch.train.fsdp_shard_dim), moonshot-v1-16b-a3b at
                full width cut to 2 layers and 1 routed expert (top 1: a
                stack of dim 0 below the data axis, as a model-16 rank
                holds), 1 x 512 a rank, 1 step: each stack on JAX's fsdp
                dim (Shard(1) of w_gate and w_up, Shard(2) of w_down) with
                half the stack's bytes a rank; the loss, the first AdamW
                moment ((1 - b1) x the clipped gradient) and the
                parameters after the step within 1e-6 of one process
                taking the ranks' slices as two microbatches, shard by
                shard on the card; each rank's max_memory_allocated.
  15. tensor  - tensor parallelism over the model axis
                (repro_torch.parallel.tensor).  K1's split entries
                (mls_quantize_rows_amax, then mls_quantize_rows_codes over
                the given max) at chatglm3-6b's training operands x (8192,
                4096) and w^T (13696, 4096) and at zamba2-7b's rank shapes
                (in_proj w^T (7408, 3584) on rank 0, with the tail, and
                (7168, 3584) on rank 1; rank 0's in_proj error (4096,
                7424), the ragged dt group padded) with rounding bytes: bit
                for bit the one-call entry's and the plain version's with
                the operand's own max, and quantize_ref's with a larger
                given max; each entry timed beside its byte bound (pass A
                also beside torch.linalg.vector_norm(x, inf)); K3 at
                zamba2-7b's rank-0 in_proj and out_proj forwards, at
                moonshot-v1-16b-a3b's and seamless-m4t-medium's rank GEMMs
                and at yi-34b's model-16 rank-0 and rank-15 wq and wo
                (TP_K1_SHAPES, TP_K3_SHAPES) bit for bit mls_matmul_ref's
                on every plan, timed beside its bound (int8 ops or bytes,
                the larger).  Then the
                main paths (TP_PATHS; counts set to 0 just before each
                step, read just after, in each rank): chatglm3-6b at full
                width cut to 2 layers; zamba2-7b at full width cut to 7
                (one segment of 6 Mamba2 layers split by heads with the
                in_proj's tail on rank 0, the shared block once, one tail
                layer); moonshot-v1-16b-a3b at full width cut to 2 MoE
                layers (64 experts, 32 a rank, top 6; the outputs gathered
                over the group); seamless-m4t-medium at full width cut to
                2 + 2 layers (the cross-attention's K/V column-parallel
                over 4096 source frames); batch 1 x 4096,
                K1/K3, stochastic rounding, bf16, full remat (the shared
                block never), AdamW at a constant lr 3e-4: one step of a
                2-rank model axis in two processes on cuda:0 over gloo
                (NCCL takes one card a rank), and a second step for its
                time alone.
                Each rank then runs the unsharded model on the same card as
                the reference (moonshot's, 29 GB with AdamW, one rank at a
                time: TP_TURNS): quantized, the loss gap printed and held
                within 5e-2, and every linear of the layers, the encoder's
                layers and the shared block given the unsharded linear's
                recorded x, g and key (column-parallel outputs and weight
                gradients, row-parallel data and weight gradients bit for
                bit, over all of a rank's pieces; the sums over the split
                within (G_r + 1) eps max|ref|), and each MoE layer's expert
                stack given the unsharded call's buffer xe and output
                gradient (this rank's outputs and weight gradients the
                unsharded stack's slices, the gathered outputs and the
                buffer's gradient whole, bit for bit); unquantized (fp32
                compute, as JAX holds its own mesh), the loss and the grad
                norm within 1e-4 relative and the rank's updated
                parameters within 1e-4 (relative L2; TP_AGREE); the tokens
                an MoE router sends to other experts than the unsharded
                step's printed (a near-tie may flip: not held);
                K1 (one call and split) and K3 launches per rank equal to
                the closed form (tp_train_launches); per-rank step ms and
                peak memory printed (gloo through the host: not a TP speed).
                Then each rank serves each path through ServeEngine, fp32
                and on K1/K3 (bf16, nearest): a prefill of 4 prompts of
                512 tokens (seamless over 1024 frames) and 8 decode steps
                teacher-forced on the unsharded engine's greedy tokens
                (same weights, the rank's card): every step's whole
                logits within 1e-4 (relative L2) of the unsharded
                engine's, fp32 and quantized with each linear and MoE
                layer fed the unsharded run's input and each
                row-parallel output held within (G_r + 1) eps max|ref|
                of the unsharded one and replaced by it (the unfed gap
                printed), the greedy tokens the same on both ranks, rank
                0's launches of the prefill and of each decode step the
                closed form (serve_launches; counts set to 0 just before
                the unfed run, read just after); prefill and decode ms per
                rank printed.  K1's split entries and K3 also at
                chatglm3-6b's rank-0 decode shapes (w_up's w^T (6912,
                4096), w_down's x (4, 6912); 4 x 4096 x 6912, 4 x 6912 x
                4096).
                Then the production model axis of 16 (TP16_PATHS): 16 gloo
                processes on cuda:0, spawned once, at full width, 1 x 512
                tokens: yi-34b cut to 1 layer (56 query heads split 4 / 3
                in whole heads, the kv heads replicated and read through
                an irregular map), seamless-m4t-medium cut to 1 + 1 over
                512 frames, 1 x 128 tokens (its attention and vocabulary
                replicated; the vocabulary one copy on the card, shared
                and frozen) and
                mamba2-370m cut to 2 layers (its tied vocabulary
                replicated).  This process runs the unsharded references
                once, a path at a time, and hands them, with the unsharded
                weights, to the ranks (CUDA IPC, through a queue); each
                rank builds its shards only.  Per
                path, fp32 and K1/K3: the loss and backward (no optimizer
                update) against the unsharded loss, grad norm and
                gradients (TP_AGREE), each quantized linear call as above
                (the linears whole on every rank bit for bit), then a
                prefill of 2 prompts of 128 tokens and 4 decode steps
                teacher-forced as above; the greedy tokens equal on all 16
                ranks; the launches of ranks 0 and 15 the closed forms
                (lm_train_launches, serve_launches at a model axis of 16).
                Sequence parallelism (tensor_parallel(..., seq_shard=
                True), JAX's SP_RULES): in the model-2 world, after the
                paths and before serving, chatglm3-6b (SP_ARCH, 2 layers,
                1 x 4096, fp32 and K1/K3): its loss and backward under SP
                against the DEFAULT layout's on the same ranks (the loss
                and every split gradient bit for bit, the replicated
                ones, summed over the group from each rank's tokens,
                within 1e-6 relative), against the unsharded model on the
                rank's card (fp32 the loss and the gradients within 1e-4,
                quantized the loss within 1e-4 and each linear call fed
                the unsharded operands as the SP step made it: the split
                slices bit for bit, a row exit's rows of the
                reduce-scattered sum within their bound), K1 / K3 launches the
                closed form (counts set to 0 just before, read just
                after), each rank's peak printed beside the DEFAULT
                one's, a 4 x 512 prefill against the DEFAULT prefill
                (logits and caches bit for bit), and one SP AdamW step's
                peak on rank 0 against the dry run's trace of the same
                step (trace_step(..., seq_shard=True) in a worker process)
                within DRYRUN_PEAK_TOL.  At the model axis of 16
                (TP16_SP_PATHS, 1 x 2048, after TP16_PATHS): mamba2-370m
                (2 layers, its tied vocabulary whole: head and loss on
                each rank's 128 tokens) and seamless-m4t-medium (1 + 1
                over 512 frames: its attention and vocabulary whole on
                the rank's tokens, K/V gathered; on K1/K3 the encoder's
                32 frames a rank stay whole), each rank's loss and
                backward against the unsharded references (fp32 the loss,
                grad norm and gradients, quantized the loss, SP_AGREE;
                quantized, each linear call fed as above, a linear kept
                whole on the rank's tokens its rows bit for bit and its
                weight gradient summed over the ranks within its bound)
                and ranks 0 and 15's launches the closed form with the
                sequences the step split.  K1's split entries and K3 also
                at seamless's token slices (x (128, 1024), x^T (1024,
                128); 128 x 1024 x 1024, 1024 x 128 x 1024).
The line before the last is {"kernels": [...]}: K3's entry also carries
`wgmma`, its wgmma variant at chatglm3-6b's w_up forward (8192 x 4096 x
13696: ms, kernel ms, the walk's beside it, int_mm_ms, the bound) and its
launches in each lm_train run.  Each kernel's `launches`
are its count on the training path (phase train; K5's in the audit's
overlap_write run; K1's split entries' on the tensor phase's main path),
`serve_launches` its count per model of the serve phase,
`lm_train_launches` per model of the lm_train phase's 4-step run,
`sweep_launches` its launches per step in each "pallas" cell of the
sweep's chip grid, `parallel_launches` its count on the parallel phase's
main path, `wire_launches` on its wire path (both ranks' 2-byte gather
steps) and `tensor_launches` per path of the tensor phase (rank 0's:
"<arch>" its training step, "<arch> serve" its quantized serving run,
"<arch> model 16" / "<arch> serve model 16" those of the model axis of 16,
"chatglm3-6b sp" / "<arch> sp model 16" the sequence-parallel steps),
each read from its own run.  The last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json
and the audit reports to chiprun_out/AUDIT_torch_*.json.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BATCH, HW, K_BLOCK = 128, 32, 128
K_BLOCK_IMPLICIT = 144  # 16 channels x 3x3 taps: legal for K4 on all 18 3x3 convs
TRAIN_STEPS = 5
PROFILER_PAD = 256  # kernels that open each kernel_ms session (see there)
# the shape each kernel is reported at on the {"kernels": ...} line (all
# timed shapes are in chiprun_out/chip_smoke.json)
REPORTED_SHAPE = {"mls_quantize_rows": "stage1_fwd_cols", "mls_quantize_given_sg": "stage1_fwd_cols",
                  "mls_matmul": "stage1_wgrad ", "implicit_conv": "stage1_conv",
                  "sabotage_overlap": "x (8, 16)", "mls_quantize_rows_amax": "x (8192, 4096)",
                  "mls_quantize_rows_codes": "x (8192, 4096)"}
# device kernels (profiler names) of each C entry point
# (K2 "none" and "c" on one group take K1's quantize_amax as pass A)
DEVICE_KERNELS = {"mls_quantize_rows": ("quantize_amax", "quantize_groups_warp",
                                        "quantize_groups_block"),
                  "mls_quantize_rows_amax": ("quantize_amax", "quantize_partials_max"),
                  "mls_quantize_rows_codes": ("quantize_groups_warp", "quantize_groups_block"),
                  "mls_quantize_given_sg": ("quantize_cols_amax", "quantize_cols_reduce",
                                            "quantize_scales", "quantize_codes",
                                            "quantize_amax"),
                  "mls_matmul": ("mls_matmul_walk", "mls_matmul_terms", "mls_matmul_sum",
                                 "mls_matmul_decode", "mls_matmul_wgmma"),
                  "implicit_conv": ("conv_amax", "implicit_conv_kernel", "conv_scale",
                                    "conv_win_amax", "conv_chan_amax", "conv_group_reduce",
                                    "conv_chan_scales")}
KERNELS = {
    "mls_quantize_rows": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                          "src/repro/kernels/mls_quantize.py:107"),
    # K1's two split entries (tensor parallelism): the same TPU kernel
    "mls_quantize_rows_amax": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                               "src/repro/kernels/mls_quantize.py:107"),
    "mls_quantize_rows_codes": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                                "src/repro/kernels/mls_quantize.py:107"),
    "mls_quantize_given_sg": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                              "src/repro/kernels/mls_quantize.py:123"),
    "mls_matmul": ("src/repro_torch/kernels/csrc/mls_matmul.cu",
                   "src/repro/kernels/mls_matmul.py:104"),
    "implicit_conv": ("src/repro_torch/kernels/csrc/implicit_conv.cu",
                      "src/repro/kernels/implicit_conv.py:403"),
    "sabotage_overlap": ("src/repro_torch/kernels/csrc/sabotage_overlap.cu",
                         "src/repro/analysis/kernel_verify.py:730"),
}
# K4's shapes on the implicit path: (x shape, w shape, stride, k_block) --
# ResNet-20's stage convs at k_block 144, and two zoo convs that the
# dispatch sends to K4 at the paper's k_block 128: GoogleNet's 3b 1x1 branch
# (CIFAR, batch 128) and ResNet-18's stage-3 stride-2 projection (ImageNet,
# batch 64)
CONV_SHAPES = {
    "stage1_conv": ((BATCH, 16, 32, 32), (16, 16, 3, 3), (1, 1), K_BLOCK_IMPLICIT),
    "stage2_conv_s2": ((BATCH, 16, 32, 32), (32, 16, 3, 3), (2, 2), K_BLOCK_IMPLICIT),
    "stage3_conv": ((BATCH, 64, 8, 8), (64, 64, 3, 3), (1, 1), K_BLOCK_IMPLICIT),
    "googlenet_3b_1x1": ((BATCH, 256, 32, 32), (128, 256, 1, 1), (1, 1), K_BLOCK),
    "resnet18_proj_s2": ((64, 128, 28, 28), (256, 128, 1, 1), (2, 2), K_BLOCK),
}

# The zoo at full width: CIFAR size for VGG-16 and GoogleNet, ImageNet size
# for the ResNets.  arch: (hw, classes, batch)
ZOO = {"vgg16": (32, 10, 128), "googlenet": (32, 10, 128), "resnet18": (224, 1000, 64),
       "resnet34": (224, 1000, 64)}
# The zoo convs whose three GEMMs K1 and K3 are held to their plain
# versions at the zoo phase's own shapes (name: arch, which conv of its
# traced list): ResNet-18's stage-1 3x3 (M 200704; the weight gradient's
# 1568 scaling groups give K3's largest split workspace), ResNet-34's
# stage-4 3x3 (K 4608, N 512; its data gradient N 4608), GoogleNet's 4b
# 3x3 (C 112: K 1008 padded to 1024, N 224) and VGG-16's last 3x3 (M 512)
ZOO_CONVS = {
    "resnet18_stage1": ("resnet18", lambda g: g.c == 64 and g.kh == 3 and g.h == 56),
    "resnet34_stage4": ("resnet34", lambda g: g.k0 == 4608),
    "googlenet_4b_3x3": ("googlenet", lambda g: g.c == 112 and g.kh == 3),
    "vgg16_conv5": ("vgg16", lambda g: g.h == 2),
}

def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, name, iters: int = 10) -> float | None:
    """Mean device time per call of ``fn`` spent in kernels whose name
    contains ``name`` (or one of a tuple of names; torch.profiler), without
    the wrapper's other work.  Late in a long process (after the traced
    training steps) the profiler has dropped the first kernels of a
    session, so each session opens with PROFILER_PAD small kernels of no
    interest; and the reading is None unless every call's kernels were
    recorded (a count that is a multiple of ``iters``), never a time too
    small."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_PAD):
            pad.add_(1)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    if not times or len(times) % iters:
        return None
    return sum(times) / 1e3 / iters


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def quantize_operand(rows: int, cols: int, pad_to: int, gen):
    """A float operand like the main path's: ``cols`` real columns of
    normal data, zero-padded to ``pad_to`` (qd_gemm's K padding)."""
    import torch

    x = torch.zeros((rows, pad_to), device="cuda")
    x[:, :cols] = torch.randn((rows, cols), generator=gen, device="cuda")
    return x


def k3_plans(M: int, N: int, K: int, kb: int, fmt) -> list:
    """K3's plans at an (M, K) @ (K, N) GEMM: the one matmul_plan picks,
    then every other variant _checked_plan accepts (the walk and the
    ordered split at the narrowest tile width that holds N, the wgmma
    variant at its 128)."""
    from repro_torch.kernels.mls_matmul import WGMMA_BN, MatmulPlan, _checked_plan, matmul_plan

    plan = matmul_plan(M, N, K, kb, fmt)
    body = "int8" if fmt.max_fraction <= 127 else "int32"
    bn = 16 if N <= 16 else 32 if N <= 32 else 64
    plans = [plan]
    for variant, width in (("walk", bn), ("split", bn), ("wgmma", WGMMA_BN)):
        try:
            p = _checked_plan(MatmulPlan(variant, body, width, 0), M, N, K, kb, fmt)
        except ValueError:
            continue
        if p.variant != plan.variant:
            plans.append(p)
    return plans


def k3_times(args, grouping: str, plans: list) -> dict:
    """The walk and the wgmma variant, where they are among the plans after
    the first, timed beside it (CUDA events, and the kernels alone; an
    ordered split that is not the first is not timed: at the LM shapes it
    takes up to 29 ms a call), and torch._int_mm on the decoded int8
    operands as int_mm_ms: the int8 dot
    alone over the whole of K, not K3's function (no group scales), a
    yardstick that the port never calls (None where _int_mm refuses the
    shape: M <= 16, or K or N not a multiple of 8)."""
    import torch

    from repro_torch.kernels import mls_matmul
    from repro_torch.kernels.ref import decode_frac_int

    run = lambda p: lambda: mls_matmul(*args, grouping, plan=p)  # noqa: E731
    out = dict(plans_ms={}, plans_kernel_ms={})
    for p in plans[1:]:
        if p.variant == "split":
            continue
        out["plans_ms"][p.variant] = cuda_ms(run(p))
        out["plans_kernel_ms"][p.variant] = kernel_ms(run(p), DEVICE_KERNELS["mls_matmul"])
    xc, w_codes, fmt = args[0], args[3], args[6]
    xd = decode_frac_int(xc, fmt).to(torch.int8)
    wd = decode_frac_int(w_codes, fmt).to(torch.int8)
    try:
        out["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(xd, wd))
    except RuntimeError:
        out["int_mm_ms"] = None
    return out


def phase_kernels(results: dict) -> list[dict]:
    """Every kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, GS_FMT_DEFAULT

    from repro_torch.kernels import mls_quantize, rounding_bytes
    from repro_torch.kernels.ref import quantize_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_hw = BATCH * HW * HW
    # quantize operands: the stage-1 forward activation (cols, K 144 padded
    # to 256) and the stage-1 weight-gradient operand cols.T (144, N*OH*OW)
    q_shapes = {"stage1_fwd_cols": (n_hw, 144, 256), "stage1_wgrad_colsT": (144, n_hw, n_hw)}
    checks, timed = [], {}
    for sname, (rows, real, padded) in q_shapes.items():
        x = quantize_operand(rows, real, padded, gen)
        r = rounding_bytes(x.shape, gen, x.device)
        for fmt in (FMT_IMAGENET, FMT_CIFAR):
            for grouping in ("nc", "n", "c", "none"):
                got = mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r, grouping)
                want = quantize_ref(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r, grouping)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                err = max(max_abs_err(a, b) for a, b in zip(got, want))
                kernel = "mls_quantize_rows" if grouping in ("nc", "n") else "mls_quantize_given_sg"
                checks.append(dict(kernel=kernel, shape=sname, fmt=str(fmt),
                                   grouping=grouping, identical=same, max_abs_err=err))
                key = (kernel, sname, str(fmt), grouping)
                if fmt is FMT_IMAGENET and grouping in ("nc", "c", "none"):
                    M, K = x.shape
                    n_sg = got[1].numel()
                    timed[key] = dict(
                        ms=cuda_ms(lambda: mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r,
                                                        grouping)),
                        kernel_ms=kernel_ms(lambda: mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT,
                                                                 r, grouping),
                                            DEVICE_KERNELS[kernel]),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, K_BLOCK, GS_FMT_DEFAULT,
                                                              r, grouping), iters=20),
                        bytes=M * K * 6 + n_sg * 4 + 4, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
        del x, r
    checks += k2_checks(gen, timed)
    checks += matmul_checks(gen, timed)
    checks += implicit_conv_checks(gen, timed)
    checks += zoo_checks(gen, timed)
    checks += nan_checks()
    results["kernel_checks"] = checks
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, shape=t["shape"], ms=t["ms"], plain_ms=t["plain_ms"],
                         bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         max_abs_err=t["max_abs_err"]))
        rows[-1].update({k: t[k] for k in ("im2col_ms", "kernel_ms", "plan", "plans_ms",
                                           "plans_kernel_ms", "int_mm_ms", "glue_ms")
                         if k in t})
        print(json.dumps({"timing": rows[-1]}))
    results["kernel_times"] = rows
    bad = [c for c in checks if not c["identical"] or not c.get("equals_im2col", True)]
    for c in checks:
        print(json.dumps(c))
    if bad:
        raise AssertionError(f"{len(bad)} kernel results differ from their plain versions")
    return rows


# K2's own shapes besides the stage-1 operands: the implicit "none" path's
# code operand (N*C*Hp, Wp) of the stage-1 input, and an all-zero operand
K2_SHAPES = {"none_codes_NCHp_Wp": (BATCH * 16 * 34, 34), "zeros": (4096, 256)}


def k2_checks(gen, timed: dict) -> list[dict]:
    """K2 at K2_SHAPES against its plain version: mls_quantize "c" and
    "none" (k_block = the width at (69632, 34), 128 on the zeros), <2,4>
    and <2,1>; and the code pass alone (quantize_given_scales) as the
    implicit "none" path calls it on the padded input, against a given
    tensor scale.  The (69632, 34) calls are timed."""
    import torch

    from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_quantize import quantize_given_scales
    from repro_torch.kernels.ref import element_codes_ref, quantize_ref

    checks = []
    for sname, (M, K) in K2_SHAPES.items():
        x = (torch.zeros((M, K), device="cuda") if sname == "zeros"
             else torch.randn((M, K), generator=gen, device="cuda"))
        r = rounding_bytes(x.shape, gen, x.device)
        kb = K if sname != "zeros" else K_BLOCK
        for fmt in (FMT_IMAGENET, FMT_CIFAR):
            for grouping in ("c", "none"):
                run = lambda: mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, r, grouping)  # noqa: E731
                got = run()
                want = quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, r, grouping)
                torch.cuda.synchronize()
                err = max(max_abs_err(a, b) for a, b in zip(got, want))
                checks.append(dict(kernel="mls_quantize_given_sg", shape=sname, fmt=str(fmt),
                                   grouping=grouping, identical=all(
                                       torch.equal(a, b) for a, b in zip(got, want)),
                                   max_abs_err=err, s_t=float(got[2])))
                if sname == "zeros" and float(got[2]) != 1.0:
                    checks[-1]["identical"] = False
                if fmt is FMT_IMAGENET and grouping == "none" and sname != "zeros":
                    timed[("mls_quantize_given_sg", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(run), kernel_ms=kernel_ms(
                            run, DEVICE_KERNELS["mls_quantize_given_sg"]),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, r,
                                                              grouping)),
                        bytes=M * K * 6 + 8, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
        if sname == "zeros":
            continue
        # the code pass alone: against the tensor scale of a larger tensor
        s_t = (x.abs().amax() * 1.5).reshape(())
        ones = torch.ones((1, 1), device="cuda")
        nearest = rounding_bytes(x.shape, None, x.device)
        run = lambda: quantize_given_scales(x, FMT_IMAGENET, s_t, ones, K, nearest)  # noqa: E731
        got = run()
        want = element_codes_ref(x, nearest, s_t * ones, FMT_IMAGENET)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        checks.append(dict(kernel="mls_quantize_given_sg", shape=f"{sname} code pass",
                           fmt=str(FMT_IMAGENET), grouping="none (given s_t)",
                           identical=torch.equal(got, want), max_abs_err=err))
        timed[("mls_quantize_given_sg", sname, "code pass")] = dict(
            ms=cuda_ms(run), kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_given_sg"]),
            plain_ms=cuda_ms(lambda: element_codes_ref(x, nearest, s_t * ones, FMT_IMAGENET)),
            bytes=M * K * 6 + 8, ops=0, max_abs_err=err,
            shape=f"{sname} code pass ({M}, {K}) none, given s_t {FMT_IMAGENET}")
        del x, r
    return checks


# K3's shapes: (M, K real, K padded, N, k_block) -- forward (cols @ wmat),
# weight gradient (cols.T @ e2d), data gradient (e2d @ wmat.T) of
# full-width ResNet-20 at batch 128, K padded as qd_gemm pads it
GEMM_SHAPES = {
    "stage1_fwd": (BATCH * HW * HW, 144, 256, 16, K_BLOCK),
    "stage1_wgrad": (144, BATCH * HW * HW, BATCH * HW * HW, 16, K_BLOCK),
    "stage2_wgrad": (288, BATCH * 16 * 16, BATCH * 16 * 16, 32, K_BLOCK),
    "stage3_wgrad": (576, BATCH * 8 * 8, BATCH * 8 * 8, 64, K_BLOCK),
    "stage3_fwd": (BATCH * 8 * 8, 576, 640, 64, K_BLOCK),
    "stage3_dgrad": (BATCH * 8 * 8, 64, 128, 576, K_BLOCK),
    "ragged": (4099, 300, 384, 37, K_BLOCK),
    "kb144_stage1_wgrad": (144, BATCH * HW * HW, 131184, 16, K_BLOCK_IMPLICIT),
    "kb144_stage1_dgrad": (BATCH * HW * HW, 16, 144, 144, K_BLOCK_IMPLICIT),
}
FMT_INT32 = (3, 1)  # fractions up to 192: K3's int32 body


def matmul_checks(gen, timed: dict) -> list[dict]:
    """K3 against mls_matmul_ref at GEMM_SHAPES: four groupings at <2,4>
    on the plan matmul_plan picks and on every other variant
    _checked_plan accepts (k3_plans: walk, ordered split, wgmma where
    k_block allows it); <3,1> (the int32 body) with grouping "nc" on the
    walk and the split where k_block 128 allows it.  The "nc" <2,4> call
    of each shape is timed on every plan, <3,1> at the stage-1 weight
    gradient."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat
    from repro_torch.kernels import mls_matmul, rounding_bytes
    from repro_torch.kernels.mls_matmul import sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    checks = []
    for sname, (M, real, K, N, kb) in GEMM_SHAPES.items():
        x = quantize_operand(M, real, K, gen)
        wt = quantize_operand(N, real, K, gen)  # the weight, quantized as (N, K)
        cases = [(FMT_IMAGENET, g) for g in ("nc", "c", "n", "none")]
        if kb == K_BLOCK:
            cases.append((EMFormat(*FMT_INT32), "nc"))
        for fmt, grouping in cases:
            xc, xsg, xst = quantize_ref(x, fmt, kb, GS_FMT_DEFAULT,
                                        rounding_bytes(x.shape, gen, x.device), grouping)
            wc, wsgT, wst = quantize_ref(wt, fmt, kb, GS_FMT_DEFAULT,
                                         rounding_bytes(wt.shape, gen, wt.device), grouping)
            args = (xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, kb)
            want = mls_matmul_ref(*args)
            plans = k3_plans(M, N, K, kb, fmt)
            plan = plans[0]
            for p in plans:
                got = mls_matmul(*args, grouping, plan=p)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                checks.append(dict(kernel="mls_matmul", shape=sname, fmt=str(fmt),
                                   grouping=grouping, k_block=kb, plan=dataclasses.asdict(p),
                                   chosen=p == plan, identical=torch.equal(got, want),
                                   max_abs_err=err, finite=bool(torch.isfinite(got).all())))
            timed_case = (fmt is FMT_IMAGENET and grouping == "nc") or \
                (fmt.max_fraction > 127 and sname == "stage1_wgrad")
            if not timed_case:
                continue
            xs_shape, ws_shape = sg_shapes(grouping, M, N, K // kb)
            run = lambda p: lambda: mls_matmul(*args, grouping, plan=p)  # noqa: E731
            row = dict(
                ms=cuda_ms(run(plan)), kernel_ms=kernel_ms(run(plan), DEVICE_KERNELS["mls_matmul"]),
                plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=20, warmup=1),
                bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                + 4 * M * N + 8,
                ops=2 * M * N * K, max_abs_err=err, plan=dataclasses.asdict(plan),
                shape=f"{'int32_' if fmt.max_fraction > 127 else ''}{sname} "
                      f"({M}x{K}x{N}) kb{kb} {grouping} {fmt}")
            row.update(k3_times(args, grouping, plans))
            timed[("mls_matmul", sname, str(fmt), grouping)] = row
        del x, wt
    return checks


def implicit_conv_checks(gen, timed: dict) -> list[dict]:
    """K4 against its plain version and the im2col route at CONV_SHAPES,
    four groupings, stochastic rounding bytes: <2,4> and <2,1> at the stage
    convs, <3,1> (the int32 body) at stage 1, <2,4> at the zoo convs (which
    the dispatch must send to K4 without a tile cache).  The <2,4> stage-conv cases are timed,
    beside the im2col route of the same conv (pad, unfold, K1 on the
    patches and on the weight, K3), and for "c" and "n" beside the
    PyTorch glue that made their compact scales before this slice
    (``_implicit_x_scales`` on a padded copy)."""
    import torch

    from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat
    from repro_torch.core import QuantConfig
    from repro_torch.kernels import (conv_geometry, implicit_conv_forward, implicit_conv_ref,
                                     mls_matmul, mls_quantize, resolve_conv_impl)
    from repro_torch.kernels.implicit_conv import _implicit_x_scales, _pad
    from repro_torch.kernels.ref import im2col

    def im2col_route(x, w, r_x, r_w, geom, fmt, grouping, kb=K_BLOCK_IMPLICIT):
        cols, _ = im2col(x, (geom.kh, geom.kw), (geom.sh, geom.sw), geom.pads)
        xc, xsg, xst = mls_quantize(cols, fmt, kb, GS_FMT_DEFAULT, r_x, grouping)
        wc, wsgT, wst = mls_quantize(w.reshape(geom.o, -1), fmt, kb, GS_FMT_DEFAULT, r_w,
                                     grouping)
        return mls_matmul(xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, kb, grouping)

    from repro_torch.kernels import autotune

    checks = []
    for sname, (xs, ws, stride, k_block) in CONV_SHAPES.items():
        geom = conv_geometry(xs, ws, stride, "SAME")
        # the default dispatch (no tile cache: the seed may send a conv to im2col)
        with autotune.override_cache(autotune.TuneCache()):
            if resolve_conv_impl(geom, QuantConfig(k_block=k_block)) != "implicit":
                raise AssertionError(f"{sname}: the dispatch does not send it to K4")
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda") * math.sqrt(2.0 / geom.k0)
        r_x = torch.randint(0, 256, (geom.m0, geom.k0), generator=gen, dtype=torch.uint8,
                            device="cuda")
        r_w = torch.randint(0, 256, (geom.o, geom.k0), generator=gen, dtype=torch.uint8,
                            device="cuda")
        # <2,4> and <2,1> on the int8 body; <3,1> (fractions up to 192) on
        # the int32 body at stage 1, k_block 72 (144 would need 24 bits)
        zoo = k_block == K_BLOCK
        cases = [(fmt, k_block) for fmt in ((FMT_IMAGENET,) if zoo else (FMT_IMAGENET, FMT_CIFAR))]
        if sname == "stage1_conv":
            cases.append((EMFormat(*FMT_INT32), 72))
        for fmt, kb in cases:
            for grouping in ("nc", "c", "n", "none"):
                kw = dict(fmt=fmt, gs_fmt=GS_FMT_DEFAULT, k_block=kb, grouping=grouping)
                got = implicit_conv_forward(x, w, r_x, r_w, stride, "SAME", **kw)
                want = implicit_conv_ref(x, w, r_x, r_w, stride, geom.pads, **kw)
                via_im2col = im2col_route(x, w, r_x, r_w, geom, fmt, grouping, kb)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                y2d = got.permute(0, 2, 3, 1).reshape(geom.m0, geom.o)
                checks.append(dict(kernel="implicit_conv", shape=sname, fmt=str(fmt),
                                   k_block=kb, grouping=grouping,
                                   identical=torch.equal(got, want), max_abs_err=err,
                                   equals_im2col=torch.equal(y2d, via_im2col),
                                   finite=bool(torch.isfinite(got).all())))
                if fmt is FMT_IMAGENET and not zoo:
                    timed[("implicit_conv", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(lambda: implicit_conv_forward(x, w, r_x, r_w, stride, "SAME",
                                                                 **kw)),
                        plain_ms=cuda_ms(lambda: implicit_conv_ref(x, w, r_x, r_w, stride,
                                                                   geom.pads, **kw)),
                        im2col_ms=cuda_ms(lambda: im2col_route(x, w, r_x, r_w, geom, fmt,
                                                               grouping)),
                        **({"glue_ms": cuda_ms(lambda: _implicit_x_scales(
                            _pad(x, geom), geom, GS_FMT_DEFAULT, kb, grouping))}
                           if grouping in ("c", "n") else {}),
                        kernel_ms=kernel_ms(lambda: implicit_conv_forward(
                            x, w, r_x, r_w, stride, "SAME", **kw),
                            DEVICE_KERNELS["implicit_conv"]),
                        # x, w, both rounding-byte tensors read once, fp32 output written once
                        bytes=4 * x.numel() + 4 * w.numel() + r_x.numel() + r_w.numel()
                        + 4 * geom.m0 * geom.o,
                        ops=2 * geom.m0 * geom.k0 * geom.o, max_abs_err=err,
                        shape=f"{sname} x{xs} w{ws} s{stride[0]} {grouping} {fmt}")
        del x, r_x
    return checks


def zoo_gemms(geom, kb: int) -> dict[str, tuple]:
    """The three GEMMs of a conv's training step as qd_gemm makes them,
    (M, K real, K padded to ``kb``, N): forward cols @ wmat, weight
    gradient cols.T @ e2d, data gradient e2d @ wmat.T."""
    pad = lambda k: -(-k // kb) * kb  # noqa: E731
    return {"fwd": (geom.m0, geom.k0, pad(geom.k0), geom.o),
            "wgrad": (geom.k0, geom.m0, pad(geom.m0), geom.o),
            "dgrad": (geom.m0, geom.o, pad(geom.o), geom.k0)}


def zoo_checks(gen, timed: dict) -> list[dict]:
    """K1 and K3 at the zoo phase's own shapes (ZOO_CONVS, traced at the
    zoo phase's sizes): for each of a conv's three GEMMs, K1 ("nc" and
    "n", <2,4>, stochastic rounding bytes) on both operands against
    quantize_ref, and K3 on those codes against mls_matmul_ref, on the plan
    matmul_plan picks and on every other variant it accepts (k3_plans).
    The "nc" calls are timed (the plain versions on 3 calls: they take up
    to seconds here)."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_matmul import sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    checks = []
    for cname, (arch, pick) in ZOO_CONVS.items():
        hw, classes, batch = ZOO[arch]
        geom = next(g for g in conv_list(arch, hw, batch, classes) if pick(g))
        for gname, (M, real, K, N) in zoo_gemms(geom, kb).items():
            sname = f"zoo {cname} {gname}"
            x = quantize_operand(M, real, K, gen)
            wt = quantize_operand(N, real, K, gen)  # the weight side, quantized as (N, K)
            rx = rounding_bytes(x.shape, gen, x.device)
            rw = rounding_bytes(wt.shape, gen, wt.device)
            for grouping in ("nc", "n"):
                qx = mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, rx, grouping)
                qw = mls_quantize(wt, fmt, kb, GS_FMT_DEFAULT, rw, grouping)
                pairs = [(qx, quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, rx, grouping)),
                         (qw, quantize_ref(wt, fmt, kb, GS_FMT_DEFAULT, rw, grouping))]
                torch.cuda.synchronize()
                err = max(max_abs_err(a, b) for got, want in pairs for a, b in zip(got, want))
                checks.append(dict(kernel="mls_quantize_rows", shape=sname, fmt=str(fmt),
                                   grouping=grouping, operands=[(M, K), (N, K)],
                                   identical=all(torch.equal(a, b) for got, want in pairs
                                                 for a, b in zip(got, want)),
                                   max_abs_err=err))
                if grouping == "nc":
                    run = lambda: mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, rx, "nc")  # noqa: E731
                    timed[("mls_quantize_rows", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(run),
                        kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_rows"]),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, rx,
                                                              grouping), iters=3, warmup=1),
                        bytes=M * K * 6 + qx[1].numel() * 4 + 4, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
                args = (*qx, qw[0].t(), qw[1].t(), qw[2], fmt, kb)
                want = mls_matmul_ref(*args)
                plans = k3_plans(M, N, K, kb, fmt)
                plan = plans[0]
                for p in plans:
                    got = mls_matmul(*args, grouping, plan=p)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    checks.append(dict(kernel="mls_matmul", shape=sname, fmt=str(fmt),
                                       grouping=grouping, k_block=kb, mkn=(M, K, N),
                                       plan=dataclasses.asdict(p), chosen=p == plan,
                                       identical=torch.equal(got, want), max_abs_err=err,
                                       finite=bool(torch.isfinite(got).all())))
                    del got
                if grouping == "nc":
                    xs_shape, ws_shape = sg_shapes(grouping, M, N, K // kb)
                    run = lambda: mls_matmul(*args, grouping, plan=plan)  # noqa: E731
                    timed[("mls_matmul", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(run), kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_matmul"]),
                        plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                        bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                        + 4 * M * N + 8,
                        ops=2 * M * N * K, max_abs_err=checks[-len(plans)]["max_abs_err"],
                        plan=dataclasses.asdict(plan),
                        shape=f"{sname} ({M}x{K}x{N}) kb{kb} {grouping} {fmt}")
                del qx, qw, want, args, pairs
            del x, wt, rx, rw
            torch.cuda.empty_cache()
    return checks


def nan_checks() -> list[dict]:
    """K1 ("nc", "n") and K4 (four groupings) on an input holding one NaN,
    against their plain versions on the CPU, whose division keeps the NaN's
    payload (the card's would give its canonical NaN): K1's scales equal
    and every code but the NaN's own; K4's every output whose patch does
    not cover the NaN.  Stage-1 shapes at batch 8 (K1: the patches of that
    conv, K padded to 256)."""
    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import conv_geometry, implicit_conv_forward, mls_quantize

    gen = torch.Generator().manual_seed(7)
    checks = []
    x = torch.randn((8 * HW * HW, 256), generator=gen)
    x[7, 40] = float("nan")
    r = torch.randint(0, 256, x.shape, generator=gen, dtype=torch.uint8)
    for grouping in ("nc", "n"):
        want = mls_quantize(x, FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT, r, grouping)
        got = [t.cpu() for t in mls_quantize(x.cuda(), FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT,
                                             r.cuda(), grouping)]
        keep = ~torch.isnan(x)
        same = (torch.equal(got[0][keep], want[0][keep]) and torch.equal(got[1], want[1])
                and float(got[2]) == float(want[2]) == 1.0)
        checks.append(dict(kernel="mls_quantize_rows", shape=f"nan {tuple(x.shape)}",
                           fmt=str(FMT_IMAGENET), grouping=grouping, identical=same,
                           max_abs_err=0.0 if same else float("nan")))
    xs, ws = (8, 16, HW, HW), (16, 16, 3, 3)
    geom = conv_geometry(xs, ws, (1, 1), "SAME")
    xc = torch.randn(xs, generator=gen)
    xc[1, 2, 3, 5] = float("nan")
    w = torch.randn(ws, generator=gen) * 0.1
    r_x = torch.randint(0, 256, (geom.m0, geom.k0), generator=gen, dtype=torch.uint8)
    r_w = torch.randint(0, 256, (geom.o, geom.k0), generator=gen, dtype=torch.uint8)
    hit = torch.zeros((8, HW, HW), dtype=torch.bool)
    hit[1, 2:5, 4:7] = True  # the outputs whose 3x3 patch covers (3, 5)
    for grouping in ("nc", "c", "n", "none"):
        kw = dict(fmt=FMT_IMAGENET, k_block=K_BLOCK_IMPLICIT, grouping=grouping)
        want = implicit_conv_forward(xc, w, r_x, r_w, (1, 1), "SAME", **kw)
        got = implicit_conv_forward(xc.cuda(), w.cuda(), r_x.cuda(), r_w.cuda(), (1, 1),
                                    "SAME", **kw).cpu()
        keep = ~hit[:, None].expand_as(got)
        same = torch.equal(got[keep], want[keep])
        checks.append(dict(kernel="implicit_conv", shape=f"nan stage1 x{xs}",
                           fmt=str(FMT_IMAGENET), grouping=grouping, identical=same,
                           max_abs_err=max_abs_err(got[keep], want[keep])))
    return checks


def conv_list(arch: str, hw: int, batch: int, num_classes: int = 10) -> list:
    """The geometry of a model's quantized convs at full width, traced by
    ``models.nn.OpTrace`` on the meta device."""
    from repro_torch.models.cnn import CNNConfig, quantized_convs

    return quantized_convs(CNNConfig(arch, num_classes, 1.0, hw), batch)


def expected_launches(qcfg, convs) -> dict[str, int]:
    """Kernel launches of one training step, from the dispatch of each conv
    (``convs``: the geometries of ``conv_list``): forward implicit (K4 +
    the weight's quantizer) or im2col (2 quantizes + K3); weight gradient
    with code reuse (grouping "none", nearest, implicit: K4's tensor-scale
    pass, a given-scale code pass, the error's quantizer, K3) or without
    (2 quantizes + K3); data gradient (2 quantizes + K3).  K2 counts its
    two entry points under one name."""
    from repro_torch.kernels import launch_counts, resolve_conv_impl

    q = "mls_quantize_rows" if qcfg.grouping in ("nc", "n") else "mls_quantize_given_sg"
    n = collections.Counter()
    for geom in convs:
        impl = resolve_conv_impl(geom, qcfg)
        if impl == "implicit":
            n.update({"implicit_conv": 1, q: 1})
        else:
            n.update({q: 2, "mls_matmul": 1})
        if qcfg.grouping == "none" and not qcfg.stochastic and impl == "implicit":
            n.update({"conv_tensor_scale": 1, "mls_quantize_given_sg": 2, "mls_matmul": 1})
        else:
            n.update({q: 2, "mls_matmul": 1})
        n.update({q: 2, "mls_matmul": 1})
    return {k: n[k] for k in launch_counts()}


def run_path(results: dict, key: str, qcfg, steps: int) -> dict[str, int]:
    """Train ``steps`` full-width steps with ``qcfg``, counts set to 0 just
    before and read just after; every step must launch what the dispatch
    says and give a finite loss.  Returns the path's launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.loop import train_variant

    want = expected_launches(qcfg, conv_list("resnet20", HW, BATCH))
    reset_launch_counts()
    res = train_variant(key, qcfg, steps, width=1.0, hw=HW, batch=BATCH, device="cuda")
    counts = launch_counts()
    step_ms = statistics.median(res.step_s[1:]) * 1e3 if steps > 1 else None
    results[key] = dict(losses=res.losses, accs=res.accs, step_s=res.step_s,
                        median_step_ms=step_ms, launches_per_step=res.launches,
                        expected_per_step=want, launches=counts)
    print(f"{key}: losses {res.losses} median step after step 1 {step_ms} ms "
          f"launches {counts}, expected per step {want}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{key}: non-finite loss: {res.losses}")
    for i, per in enumerate(res.launches):
        if per != want:
            raise AssertionError(f"{key} step {i}: launches {per}, expected {want}")
    return counts


def phase_train(results: dict) -> dict[str, int]:
    """The main path, the given-scale path, the implicit path and its
    grouping-"none" pass; returns each kernel's launches on its path."""
    from repro_torch.core import FMT_IMAGENET, QuantConfig

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    main = run_path(results, "train", qcfg, TRAIN_STEPS)
    if expected_launches(qcfg, conv_list("resnet20", HW, BATCH)) != {
            "mls_quantize_rows": 120, "mls_quantize_rows_amax": 0,
            "mls_quantize_rows_codes": 0, "mls_quantize_given_sg": 0, "mls_matmul": 60,
            "implicit_conv": 0, "conv_tensor_scale": 0, "sabotage_overlap": 0}:
        raise AssertionError("the k_block-128 path no longer takes 120 quantize and 60 GEMM "
                             "launches per step on im2col alone")
    # paper Table IV grouping "c": the given-scale quantize kernel's path
    qc = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="c", stochastic=True)
    c_counts = run_path(results, "train_grouping_c", qc, 2)
    # the implicit path: K4 on the 18 3x3 convs
    qi = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK_IMPLICIT, grouping="nc", stochastic=True)
    i_counts = run_path(results, "train_implicit", qi, TRAIN_STEPS)
    qn = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK_IMPLICIT, grouping="none",
                     stochastic=False)
    run_path(results, "train_implicit_none", qn, 2)
    return {**main, "mls_quantize_given_sg": c_counts["mls_quantize_given_sg"],
            "implicit_conv": i_counts["implicit_conv"]}


def phase_trace(results: dict) -> None:
    """Where a step's time goes, on the main path, the implicit path and
    the grouping-"c" path (K2's): 3 more steps of each under
    torch.profiler; device time by kernel, the port's kernels against the
    rest, and the device's idle share of the host-clock step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.train.loop import train_variant

    from repro_torch.kernels import launch_counts, reset_launch_counts

    ours = tuple(n for names in DEVICE_KERNELS.values() for n in names)
    steps = 3
    for key, k_block, grouping in (("trace", K_BLOCK, "nc"),
                                   ("trace_implicit", K_BLOCK_IMPLICIT, "nc"),
                                   ("trace_grouping_c", K_BLOCK, "c")):
        qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=k_block, grouping=grouping,
                           stochastic=True)
        reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = train_variant("traced", qcfg, steps, width=1.0, hw=HW, batch=BATCH,
                                device="cuda", log=lambda *_: None)
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        ours_ms = sum(v for k, v in by_name.items() if any(o in k for o in ours))
        launched = launch_counts()  # K1 and K2 share quantize_amax: only the path's own
        by_entry = {entry: sum(v for k, v in by_name.items() if any(o in k for o in names))
                    / steps for entry, names in DEVICE_KERNELS.items() if launched[entry]}
        device_ms = sum(by_name.values())
        host_ms = sum(res.step_s) * 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        trace = dict(k_block=k_block, grouping=grouping, steps=steps,
                     host_ms_per_step=host_ms / steps,
                     device_ms_per_step=device_ms / steps,
                     port_kernels_ms_per_step=ours_ms / steps,
                     kernels_ms_per_step_by_entry=by_entry,
                     other_device_ms_per_step=(device_ms - ours_ms) / steps,
                     device_idle_share=1.0 - device_ms / host_ms if host_ms else None,
                     top_kernels_ms_per_step=[(k[:90], v / steps) for k, v in top])
        results[key] = trace
        print(json.dumps({key: trace}))
        if device_ms <= 0:
            raise AssertionError("the profiler recorded no device time")


def card_vs_cpu(qcfg) -> dict:
    """One small ResNet-20 train step (width 1/4, 8x8, batch 4) on the card
    and on the CPU (the plain versions): the loss, logits and gradients
    compared, and the card's launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.cnn import CNNConfig, init_cnn

    cfg = CNNConfig("resnet20", width_mult=0.25, in_hw=8)
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn((4, 3, 8, 8), generator=gen), torch.randint(0, 10, (4,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_cnn(cfg, seed=3, device=dev)
        reset_launch_counts()
        logits = model(x.to(dev), qcfg)
        loss = F.cross_entropy(logits, y.to(dev))
        loss.backward()
        out[dev] = (float(loss.detach()), logits.detach().cpu(),
                    {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                    launch_counts())
    (l_cpu, z_cpu, g_cpu, _), (l_gpu, z_gpu, g_gpu, counts) = out["cpu"], out["cuda"]
    cos, grad_rel = 1.0, 0.0
    for n in g_cpu:
        a, b = g_gpu[n].flatten().double(), g_cpu[n].flatten().double()
        cos = min(cos, float(a @ b / (a.norm() * b.norm())))
        grad_rel = max(grad_rel, float((a - b).norm() / b.norm()))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    z_err = max_abs_err(z_cpu, z_gpu)
    # tolerance: the quantized convs are bit-exact, but the stem conv, BN
    # and the classifier reduce in another order on the card (on the
    # fake-quant backend every conv is an fp32 conv of the quantized
    # operands), so the last bits differ (seen: loss equal, logits within
    # 7.2e-7, fp32 gradient cosine above 1 - 1.2e-7); each limit is far
    # below what a wrong kernel or a flipped code gives
    ok = (rel <= 1e-5 and z_err <= 1e-5 and cos >= 1 - 1e-5 and grad_rel <= 1e-4
          and bool(torch.isfinite(z_gpu).all()))
    return dict(k_block=qcfg.k_block, backend=qcfg.backend, loss_cpu=l_cpu, loss_gpu=l_gpu,
                loss_rel=rel, min_grad_cos=cos, max_grad_rel=grad_rel, logits_max_abs=z_err,
                card_launches=counts, agree=ok)


def phase_agree(results: dict) -> None:
    """One small train step on the card agrees with the CPU's plain run, on
    im2col (k_block 32) and with every 3x3 conv implicit (k_block 36)."""
    from repro_torch.core import FMT_IMAGENET, QuantConfig

    disagree = []
    for k_block in (32, 36):
        key = "agree" if k_block == 32 else "agree_implicit"
        results[key] = r = card_vs_cpu(QuantConfig(fmt=FMT_IMAGENET, k_block=k_block,
                                                   stochastic=False))
        print(f"{key}: {r}")
        if not r["agree"]:
            disagree.append(key)
        if (r["card_launches"]["implicit_conv"] > 0) != (k_block == 36):
            disagree.append(f"{key}: launches {r['card_launches']}")
    if disagree:
        raise AssertionError(f"card and CPU disagree: {disagree}")


def traced_step(state, qcfg, lr: float) -> dict:
    """One more train step under torch.profiler: device busy (the sum of
    kernel times), the port's kernels' share, and the device's idle share
    of the host-clock step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.loop import train_step

    ours = tuple(n for names in DEVICE_KERNELS.values() for n in names)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, qcfg, lr)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(host_ms_under_profiler=host_ms, device_ms=device_ms,
                port_kernels_ms=sum(v for k, v in by_name.items() if any(o in k for o in ours)),
                device_idle_share=1.0 - device_ms / host_ms,
                top_kernels_ms=[(k[:80], v) for k, v in top])


ZOO_STEPS = 2


def phase_zoo(results: dict) -> None:
    """VGG-16, GoogleNet, ResNet-18 and ResNet-34 at full width on the
    quantized backend (<2,4>, k_block 128, "nc", stochastic rounding):
    ZOO_STEPS steps each with counts set to 0 just before and read just
    after; finite losses, and every step's launches equal to the dispatch's
    count over the model's traced quantized convs (K1 and K3 on every
    model, K4 where the dispatch picks it).  Step times (host clock, after
    a device sync), the peak device memory, and one more step traced."""
    import torch

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train.loop import init_state, train_step

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    bad = []
    for arch, (hw, classes, batch) in ZOO.items():
        want = expected_launches(qcfg, conv_list(arch, hw, batch, classes))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(CNNConfig(arch, classes, 1.0, hw), batch, seed=0, device="cuda")
        losses, step_ms, per_step = [], [], []
        reset_launch_counts()
        for _ in range(ZOO_STEPS):
            before = launch_counts()
            t0 = time.perf_counter()
            loss, _ = train_step(state, qcfg, 0.05)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({k: v - before[k] for k, v in launch_counts().items()})
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        trace = traced_step(state, qcfg, 0.05)
        r = dict(hw=hw, classes=classes, batch=batch, losses=losses, step_ms=step_ms,
                 launches_per_step=per_step, expected_per_step=want, launches=counts,
                 peak_memory_bytes=peak, trace=trace)
        results[f"zoo_{arch}"] = r
        print(f"zoo {arch}: {hw}x{hw} batch {batch}: losses {losses} step ms {step_ms} "
              f"peak memory {peak / 2**30:.2f} GiB launches/step {per_step[0]} "
              f"device busy {trace['device_ms']:.1f} ms of {trace['host_ms_under_profiler']:.1f}"
              f" (profiled)")
        if not all(math.isfinite(v) for v in losses):
            bad.append(f"{arch}: non-finite loss {losses}")
        if any(p != want for p in per_step):
            bad.append(f"{arch}: launches {per_step}, expected {want}")
        if not (counts["mls_quantize_rows"] and counts["mls_matmul"]):
            bad.append(f"{arch}: K1 or K3 not launched: {counts}")
        del state
    if bad:
        raise AssertionError("; ".join(bad))


FAKE_QUANT_STEPS = 5


def phase_fakequant(results: dict) -> None:
    """The fake-quant backend (the JAX package's default; the quantizer is
    PyTorch code and the convs are fp32 convs, as the JAX package runs them
    outside any Pallas kernel, so no kernel of the port launches): full-width
    ResNet-20, batch 128, <2,1>, stochastic rounding, FAKE_QUANT_STEPS
    steps with finite losses; one more step traced; and a small step on
    the card that agrees with the CPU."""
    import torch

    from repro_torch.core import FMT_CIFAR, QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train.loop import init_state, train_step

    qcfg = QuantConfig(fmt=FMT_CIFAR, k_block=K_BLOCK, backend="fake_quant")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(CNNConfig("resnet20", 10, 1.0, HW), BATCH, seed=0, device="cuda")
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(FAKE_QUANT_STEPS):
        t0 = time.perf_counter()
        losses.append(train_step(state, qcfg, 0.05)[0])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    r = dict(losses=losses, step_ms=step_ms, median_step_ms=statistics.median(step_ms[1:]),
             peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts,
             trace=traced_step(state, qcfg, 0.05),
             agree=card_vs_cpu(QuantConfig(fmt=FMT_CIFAR, k_block=32, stochastic=False,
                                           backend="fake_quant")))
    results["fake_quant"] = r
    print(f"fake_quant: losses {losses} median step {r['median_step_ms']:.2f} ms peak "
          f"{r['peak_memory_bytes'] / 2**30:.2f} GiB device busy {r['trace']['device_ms']:.1f} ms"
          f"; agree {r['agree']}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fake_quant: non-finite loss {losses}")
    if any(counts.values()):
        raise AssertionError(f"fake_quant launched the port's kernels: {counts}")
    if not r["agree"]["agree"]:
        raise AssertionError(f"fake_quant: card and CPU disagree: {r['agree']}")


def phase_driver(results: dict) -> None:
    """The CIFAR driver (examples/torch_train_cifar_lowbit.py) for a few
    full-width steps on the quantized backend; a checkpoint of the main
    path's state saved on the card and restored on the card and on the CPU
    (every tensor equal to the saved one); and the run resumed from it,
    whose next loss equals the uninterrupted run's."""
    import importlib.util
    import tempfile

    import torch

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train import CheckpointManager
    from repro_torch.train.loop import init_state, train_step

    spec = importlib.util.spec_from_file_location(
        "torch_train_cifar_lowbit", ROOT / "examples" / "torch_train_cifar_lowbit.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    runs = example.main(["--steps", "3", "--width", "1.0", "--hw", str(HW), "--batch",
                         str(BATCH), "--backend", "quantized", "--device", "cuda"])
    bad = [f"driver {n}: non-finite loss {r.losses}" for n, r in runs.items()
           if not all(math.isfinite(v) for v in r.losses)]

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK)
    cfg = CNNConfig("resnet20", 10, 1.0, HW)
    run = init_state(cfg, BATCH, seed=0, device="cuda")
    for _ in range(2):
        train_step(run, qcfg, 0.05)
    saved = run.state_dict()
    saved_copy = [t.detach().clone() for t in _tensors(saved)]  # the state dict is live
    same = True
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2)
        mgr.save(run.step, saved, blocking=False)
        next_loss = train_step(run, qcfg, 0.05)[0]  # the uninterrupted run steps on
        mgr.wait()
        for device in ("cuda", "cpu"):
            restored = mgr.restore(init_state(cfg, BATCH, seed=0, device="cuda").state_dict(),
                                   device=device)
            for a, b in zip(saved_copy, _tensors(restored)):
                same &= b.device.type == device and torch.equal(a.cpu(), b.cpu())
        resumed = init_state(cfg, BATCH, seed=0, device="cuda")
        resumed.load_state_dict(mgr.restore(resumed.state_dict(), device="cuda"))
        resumed_loss = train_step(resumed, qcfg, 0.05)[0]
    results["driver"] = dict(example_losses={n: r.losses for n, r in runs.items()},
                             straggler={n: r.straggler for n, r in runs.items()},
                             restored_equal=same, next_loss=next_loss,
                             resumed_loss=resumed_loss)
    print(f"driver: {results['driver']}")
    if not same:
        bad.append("a restored tensor differs from the saved one")
    if resumed_loss != next_loss:
        bad.append(f"resumed loss {resumed_loss} != uninterrupted {next_loss}")
    if bad:
        raise AssertionError("; ".join(bad))


# The serve phase: the LM serving path (repro_torch.serve.ServeEngine) on
# the quantized kernels, random weights from seed 0, bf16 compute as the
# FULL configs say.  name: (config overrides, prompt length); every model
# serves SERVE_BATCH prompts and SERVE_NEW new tokens (one prefill, then
# SERVE_NEW - 1 decode steps).  mamba2-370m's prompt of 320 is not a
# multiple of its ssm_chunk 256: the chunk is 160 by the divisor rule.
# zamba2-7b's depth is cut from 81 to 12 layers (the shared block runs
# twice) and its window set to 136, under 128 + 15, so that the ring
# buffer wraps during decode.  The MoE configs are cut in depth to what one
# card holds in fp32 beside the experts' fake-quant temporaries:
# moonshot-v1-16b-a3b to 4 of 48 layers (0.571 G parameters, 2.28 GB, per
# layer; the embedding and head 2.68 GB), llama4-scout-17b-a16e to 2 of 48
# (8.81 GB per layer, embedding and head 8.28 GB): SERVE_CUTS.
# seamless-m4t-medium runs whole, its encoder over SERVE_SRC_LEN frames of
# random frontend embeddings per prompt.
SERVE_BATCH, SERVE_NEW, SERVE_SRC_LEN = 4, 16, 1024
SERVE_MODELS = {
    "chatglm3-6b": ({}, 128),
    "mamba2-370m": ({}, 320),
    "zamba2-7b": ({"n_layers": 12, "window": 136}, 128),
    "moonshot-v1-16b-a3b": ({"n_layers": 4}, 128),
    "llama4-scout-17b-a16e": ({"n_layers": 2}, 128),
    "seamless-m4t-medium": ({}, 128),
}
SERVE_CUTS = {
    "zamba2-7b": "n_layers 81 -> 12 (2 shared-block applications), window 136",
    "moonshot-v1-16b-a3b": "n_layers 48 -> 4 (all 48 are 112 GB of fp32 weights; 16 until "
                           "the model-16 world, 8 until sequence parallelism took the time)",
    "llama4-scout-17b-a16e": "n_layers 48 -> 2 (8.8 GB of fp32 weights per layer; 4 until the "
                             "model-16 world took the time)",
}


def lm_inputs(cfg, tokens, gen, src_len: int) -> dict:
    """The batch of ``tokens`` as a user passes it: the encoder-decoder's
    also holds ``src_len`` frames of random frontend embeddings from
    ``gen`` for its encoder (``src_emb`` (B, src_len, frontend_dim))."""
    import torch

    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_emb"] = torch.randn((tokens.shape[0], src_len, cfg.frontend_dim),
                                       generator=gen, device=tokens.device)
    return batch


CONFIG_KEYS = ("n_layers", "enc_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "moe_d_ff",
               "n_experts", "top_k", "n_shared_experts", "vocab", "compute_dtype", "window",
               "remat")


def serve_linears(cfg, prefill: bool = False) -> int:
    """Quantized linears per serving step (decode, or with ``prefill`` the
    prefill); each launches K1 twice and K3 once.  An attention block has 4
    (wq, wk, wv, wo) and its MLP 3 (w_up, w_gate, w_down; 2 ungated); an
    MoE layer its attention and its shared expert's MLP (the routed experts
    run fake-quant GEMMs, no kernel); a Mamba2 layer 2 (in_proj, out_proj);
    an encoder-decoder's decoder layer its self-attention, the cross
    attention's wq and wo (its K/V are computed once at prefill,
    unquantized) and its MLP, and the prefill also runs the encoder."""
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.family == "dense":
        return (4 + mlp) * cfg.n_layers
    if cfg.family == "moe":
        return (4 + (mlp if cfg.n_shared_experts else 0)) * cfg.n_layers
    if cfg.family == "encdec":
        return (6 + mlp) * cfg.n_layers + ((4 + mlp) * cfg.enc_layers if prefill else 0)
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    return 2 * cfg.n_layers + (4 + mlp) * (cfg.n_layers // cfg.attn_every)


def lm_train_launches(cfg, microbatch: int = 1, model_axis: int = 1,
                      seq_split: tuple[bool, bool] = (False, False)) -> dict[str, int]:
    """K1 and K3 launches of one LM training step (lm_loss forward and
    backward): each quantized linear runs qd_gemm for its forward, its data
    gradient and its weight gradient (K1 on both operands, then K3), and
    under full remat once more for the recomputed forward; the hybrid's
    shared block is not remat'd.  In training the encoder-decoder's cross
    attention computes its K/V from the encoder's output, quantized, so a
    decoder layer has 8 attention linears.  Remat "dots" recomputes the
    forward too: K3 runs inside an autograd.Function that its policy does
    not see.  Times the microbatches.  With a ``model_axis`` above 1
    (tensor-parallel) the launches of one rank (:func:`tp_train_launches`;
    ``seq_split``: under sequence parallelism, the sequences split)."""
    if model_axis > 1:
        return tp_train_launches(cfg, model_axis, microbatch, seq_split)
    per = 3 if cfg.remat == "none" else 4
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.family == "dense":
        k3 = (4 + mlp) * cfg.n_layers * per
    elif cfg.family == "moe":
        k3 = (4 + (mlp if cfg.n_shared_experts else 0)) * cfg.n_layers * per
    elif cfg.family == "encdec":
        k3 = ((4 + mlp) * cfg.enc_layers + (8 + mlp) * cfg.n_layers) * per
    else:
        k3 = 2 * cfg.n_layers * per  # in_proj, out_proj
        if cfg.family == "hybrid":
            k3 += (4 + mlp) * (cfg.n_layers // cfg.attn_every) * 3
    return {"mls_quantize_rows": 2 * k3 * microbatch, "mls_matmul": k3 * microbatch}


def tp_attention(cfg, model_axis: int, q_split: bool = False,
                 kv_split: bool = False) -> tuple[int, int, int]:
    """An attention's (column-parallel, row-parallel, whole) quantized
    linears on one rank at a model axis of ``model_axis``
    (parallel.tensor): wq, wk, wv column and wo row where the heads split
    with their kv heads (evenly); wq column, wo row and the replicated wk,
    wv whole where the kv heads stay replicated (an uneven split in whole
    units, or kv heads the axis does not divide); all four whole where the
    attention has fewer units than ranks and stays replicated.  Under
    sequence parallelism, a whole linear on a split sequence (``q_split``:
    the queries' wq and wo; ``kv_split``: the keys' wk and wv) runs on the
    rank's tokens, its x and error token slices: it launches as a
    column-parallel one (x and x^T sharded where a column linear holds w
    and the error sharded), so it counts with them."""
    from repro_torch.parallel.tensor import attention_heads, rank_heads

    kv = 2 if kv_split else 0
    if attention_heads(cfg, model_axis) is None:
        q = 2 if q_split else 0
        return (q + kv, 0, 4 - q - kv)
    return (1 + kv, 1, 2 - kv) if rank_heads(cfg, model_axis, 0)[2] is not None else (3, 1, 0)


def tp_train_launches(cfg, model_axis: int, microbatch: int = 1,
                      seq_split: tuple[bool, bool] = (False, False)) -> dict[str, int]:
    """One rank's K1 and K3 launches of a tensor-parallel LM training step
    (parallel.tensor): a GEMM operand held whole takes K1's one call
    (mls_quantize_rows), a sharded one K1's two (mls_quantize_rows_amax,
    then mls_quantize_rows_codes).  A column-parallel linear (wq, w_up,
    w_gate, wk / wv where the kv heads split, and a Mamba2 in_proj) holds x
    and x^T whole and shards w, the error and its transpose: 2 whole and 4
    sharded operands, and the recomputed forward one more of each under
    remat.  A row-parallel one (wo, w_down, a Mamba2 out_proj) holds the
    error and its transpose whole: 2 and 4, and its recomputed forward 2
    sharded.  Replicated kv linears, and every linear of an attention that
    stays replicated (:func:`tp_attention`), are whole: 6, and 2 under
    remat.  Each linear runs K3 three times (four under remat).  The
    hybrid's shared block (after each full segment) is never remat'd.  An
    MoE layer's quantized linears are its attention's and its shared
    expert's (the routed experts reach no kernel), an encoder layer's a
    dense block's, a decoder layer's its self- and cross-attention's and
    its MLP's.  Uneven heads launch as even ones.  ``seq_split``: under
    sequence parallelism, whether the step split the decoder's and the
    encoder's sequence (``model.seq_split``; :func:`tp_attention`)."""
    dec, enc = seq_split

    def linears(cols: int, rows: int, whole: int, r: int) -> tuple[int, int, int]:
        return (cols * (2 + r) + rows * 2 + whole * (6 + 2 * r),
                cols * (4 + r) + rows * (4 + 2 * r), (cols + rows + whole) * (3 + r))

    def attention(r: int, q: bool = dec, kv: bool = dec) -> tuple[int, int, int]:
        return linears(*tp_attention(cfg, model_axis, q, kv), r) if cfg.n_heads else (0, 0, 0)

    def mlp(r: int) -> tuple[int, int, int]:  # w_up (w_gate) column, w_down row
        return linears(2 if cfg.gated_mlp else 1, 1, 0, r)

    def add(*parts) -> tuple[int, int, int]:
        return tuple(sum(v) for v in zip(*parts))

    def block(r: int) -> tuple[int, int, int]:  # an attention+MLP block's (one, split, k3)
        return add(attention(r), mlp(r))

    r = 0 if cfg.remat == "none" else 1
    if cfg.family == "dense":
        one, split, k3 = (v * cfg.n_layers for v in block(r))
    elif cfg.family == "moe":
        layer = add(attention(r), *([mlp(r)] if cfg.n_shared_experts else []))
        one, split, k3 = (v * cfg.n_layers for v in layer)
    elif cfg.family == "encdec":  # the cross-attention's keys on the encoder's sequence
        one, split, k3 = add(*[add(attention(r, enc, enc), mlp(r))] * cfg.enc_layers,
                             *[add(attention(r), attention(r, dec, enc), mlp(r))]
                             * cfg.n_layers)
    else:  # Mamba2 layers: in_proj column-parallel, out_proj row-parallel
        one, split, k3 = ((2 + r) + 2, (4 + r) + (4 + 2 * r), 2 * (3 + r))
        one, split, k3 = (v * cfg.n_layers for v in (one, split, k3))
        if cfg.family == "hybrid":
            shared = cfg.n_layers // cfg.attn_every
            one, split, k3 = (a + b * shared for a, b in zip((one, split, k3), block(0)))
    n = microbatch
    return {"mls_quantize_rows": one * n, "mls_quantize_rows_amax": split * n,
            "mls_quantize_rows_codes": split * n, "mls_matmul": k3 * n}


def serve_launches(cfg, model_axis: int = 1, prefill: bool = False) -> dict[str, int]:
    """K1 and K3 launches of one serving step (decode, or with ``prefill``
    the prefill; :func:`serve_linears`).  With a ``model_axis`` above 1
    (parallel.tensor) one rank's: a column-parallel linear (wq, w_up,
    w_gate, wk / wv where the kv heads split, a Mamba2 in_proj) holds x
    whole (K1's one call) and shards w (K1's two: mls_quantize_rows_amax,
    then mls_quantize_rows_codes); a row-parallel one (wo, w_down, a
    Mamba2 out_proj) shards both; replicated kv linears, and the linears of
    an attention that stays replicated (:func:`tp_attention`), hold both
    whole.  Each runs K3 once.  A decoder layer's cross attention runs wq
    and wo (its K/V, cached at prefill, are unquantized)."""
    if model_axis == 1:
        n = serve_linears(cfg, prefill)
        return {"mls_quantize_rows": 2 * n, "mls_matmul": n}
    mlp = (2 if cfg.gated_mlp else 1, 1, 0)  # (column, row, whole) linears
    attn = tp_attention(cfg, model_axis) if cfg.n_heads else (0, 0, 0)
    cross = (0, 0, 2) if attn == (0, 0, 4) else (1, 1, 0)

    def times(n, *parts):
        return tuple(n * sum(v) for v in zip(*parts))

    if cfg.family == "dense":
        col, row, whole = times(cfg.n_layers, attn, mlp)
    elif cfg.family == "moe":
        col, row, whole = times(cfg.n_layers, attn, mlp if cfg.n_shared_experts else (0, 0, 0))
    elif cfg.family == "encdec":
        col, row, whole = times(cfg.n_layers, attn, cross, mlp)
        if prefill:
            col, row, whole = (a + b for a, b in zip((col, row, whole),
                                                     times(cfg.enc_layers, attn, mlp)))
    else:  # Mamba2 layers: in_proj column-parallel, out_proj row-parallel
        col, row, whole = times(cfg.n_layers, (1, 1, 0))
        if cfg.family == "hybrid":
            col, row, whole = (a + b for a, b in zip(
                (col, row, whole), times(cfg.n_layers // cfg.attn_every, attn, mlp)))
    return {"mls_quantize_rows": col + 2 * whole, "mls_quantize_rows_amax": col + 2 * row,
            "mls_quantize_rows_codes": col + 2 * row, "mls_matmul": col + row + whole}


def traced_decode(engine, cache, tok) -> dict:
    """One decode step under torch.profiler: device busy (the sum of kernel
    times), K1's and K3's kernel time, the MoE experts' fake-quant
    (_experts_ms), and the device's idle share of the host-clock step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = engine.decode(cache, tok)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    of = lambda entry: sum(v for k, v in by_name.items()  # noqa: E731
                           if any(n in k for n in DEVICE_KERNELS[entry]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(host_ms_under_profiler=host_ms, device_ms=device_ms,
                k1_ms=of("mls_quantize_rows"), k3_ms=of("mls_matmul"),
                experts_ms=_experts_ms(prof), device_idle_share=1.0 - device_ms / host_ms,
                top_kernels_ms=[(k[:80], v) for k, v in top],
                finite=bool(torch.isfinite(logits).all()))


def serve_model(name: str, smi: str) -> dict:
    """Serve one of SERVE_MODELS at full width through ServeEngine: the
    launches of a whole ``generate`` (counts set to 0 just before, read just
    after), then a prefill and SERVE_NEW - 1 decode steps timed one by one
    (host clock after a device sync) with each step's launches, and one
    decode step traced.  The encoder-decoder's prompts carry SERVE_SRC_LEN
    frames each for its encoder."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import ServeEngine

    over, prompt_len = SERVE_MODELS[name]
    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, init_lm(cfg, seed=0, device="cuda"),
                         max_len=prompt_len + SERVE_NEW, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = lm_inputs(cfg, torch.randint(0, cfg.vocab, (SERVE_BATCH, prompt_len),
                                           generator=gen, device="cuda"), gen, SERVE_SRC_LEN)
    n, n_pre = serve_linears(cfg), serve_linears(cfg, prefill=True)
    want = {"mls_quantize_rows": 2 * n, "mls_matmul": n}
    want_pre = {"mls_quantize_rows": 2 * n_pre, "mls_matmul": n_pre}
    want_run = {k: want_pre[k] + (SERVE_NEW - 1) * v for k, v in want.items()}

    reset_launch_counts()
    tokens = engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    launched = launch_counts()
    bad = []
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_NEW) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        bad.append(f"generate gave {tuple(tokens.shape)} tokens out of range")
    if {k: launched[k] for k in want} != want_run:
        bad.append(f"generate launched {launched}, expected {want_run}")

    steps_ms, per_step, finite = [], [], True
    with torch.inference_mode():
        for i in range(SERVE_NEW):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = engine.prefill(prompts)
            else:
                logits, cache = engine.decode(cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: launch_counts()[k] - before[k] for k in want})
            finite &= bool(torch.isfinite(logits).all())
        same_tokens = torch.equal(tokens[:, -1:], tok)
    trace = traced_decode(engine, cache, tok)
    peak = torch.cuda.max_memory_allocated()
    decode_ms = statistics.median(steps_ms[1:])
    r = dict(config={k: getattr(cfg, k) for k in CONFIG_KEYS},
             cut=SERVE_CUTS.get(name), params=sum(p.numel() for p in engine.model.parameters()),
             batch=SERVE_BATCH, prompt_len=prompt_len, new_tokens=SERVE_NEW,
             src_len=SERVE_SRC_LEN if cfg.family == "encdec" else None,
             prefill_ms=steps_ms[0], decode_ms=steps_ms[1:], decode_ms_median=decode_ms,
             tokens_per_s=SERVE_BATCH * 1e3 / decode_ms, launches_generate=launched,
             launches_per_step=per_step, expected_per_step=[want_pre] + [want] * (SERVE_NEW - 1),
             trace=trace,
             peak_memory_bytes=peak, finite=finite and trace["finite"],
             generate_equals_stepwise=same_tokens, nvidia_smi=smi)
    print(f"serve {name} ({smi}): {r['params'] / 1e9:.3f} G params, prefill "
          f"{r['prefill_ms']:.2f} ms, decode {decode_ms:.2f} ms/step median "
          f"({r['tokens_per_s']:.1f} tokens/s), device busy {trace['device_ms']:.2f} ms of "
          f"{trace['host_ms_under_profiler']:.2f} (idle {trace['device_idle_share']:.3f}), K1 "
          f"{trace['k1_ms']:.2f} ms, K3 {trace['k3_ms']:.2f} ms, experts' fake-quant "
          f"{trace['experts_ms']:.2f} ms per decode step, peak {peak / 2**30:.2f} GiB, launches "
          f"per prefill {per_step[0]}, per decode step {per_step[-1]}"
          + (f"; cut: {r['cut']}" if r["cut"] else ""))
    if not r["finite"]:
        bad.append("a non-finite logit")
    if per_step != r["expected_per_step"]:
        bad.append(f"launches per step {per_step}, expected {r['expected_per_step']}")
    if (cfg.family == "moe") != (trace["experts_ms"] > 0):
        bad.append(f"the experts' fake-quant read {trace['experts_ms']} device ms")
    if not same_tokens:
        bad.append("generate's last tokens differ from the stepwise run's")
    del engine, cache, logits
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    return r


# K1 and K3 at the serving path's GEMMs, (M, K, N): the linear's input x
# (M, K), its weight quantized transposed (N, K), and the GEMM
SERVE_GEMMS = {
    "chatglm3 decode wq/wo": (4, 4096, 4096),
    "chatglm3 decode wk/wv": (4, 4096, 256),
    "chatglm3 decode qkv 4608": (4, 4096, 4608),
    "chatglm3 decode w_up/w_gate": (4, 4096, 13696),
    "chatglm3 decode w_down": (4, 13696, 4096),
    "chatglm3 prefill w_up": (512, 4096, 13696),
    "mamba2 prefill in_proj": (512, 1024, 4384),
    "mamba2 decode in_proj": (4, 1024, 4384),
    "mamba2 decode out_proj": (4, 2048, 1024),
    "zamba2 decode in_proj": (4, 3584, 14576),
    "zamba2 decode out_proj": (4, 7168, 3584),
}
# the models whose serving GEMMs serve_gemms reads from their configs
SERVE_GEMM_MODELS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "seamless-m4t-medium")


def serve_gemms() -> dict[str, tuple]:
    """{label: (M, K, N, timed)}: SERVE_GEMMS (all timed), then the distinct
    (M, K, N) of every quantized linear of the SERVE_GEMM_MODELS configs (as
    cut) at decode (M = SERVE_BATCH; timed) and at prefill (M = SERVE_BATCH
    x the prompt, or x SERVE_SRC_LEN in an encoder), read from the model
    built on the meta device.  Not quantized, so not here: the LM head,
    the frontend projection, the MoE router and experts (fake-quant GEMMs)
    and the encoder-decoder's cross K/V, which prefill computes in fp32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import nn as L
    from repro_torch.models.lm import LM

    out = {k: (*v, True) for k, v in SERVE_GEMMS.items()}
    for name in SERVE_GEMM_MODELS:
        over, prompt_len = SERVE_MODELS[name]
        cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
        with torch.device("meta"):
            model = LM(cfg)
        seen = set()
        for mname, mod in model.named_modules():
            if (not isinstance(mod, L.Linear) or mname == "frontend_proj"
                    or mname.endswith(("router", "xattn.wk", "xattn.wv"))):
                continue
            k, n = mod.w.shape
            enc = mname.startswith("enc_layers.")
            steps = [("prefill", SERVE_BATCH * (SERVE_SRC_LEN if enc else prompt_len))]
            if not enc:
                steps.insert(0, ("decode", SERVE_BATCH))
            for step, m in steps:
                if (m, k, n) not in seen:
                    seen.add((m, k, n))
                    where = "encoder " if enc else ""
                    label = f"{name.split('-')[0]} {step} {where}{'.'.join(mname.split('.')[-2:])}"
                    out[label] = (m, k, n, step == "decode")
    return out


def serve_kernel_checks(timed: dict) -> list[dict]:
    """K1 ("nc", <2,4>, nearest rounding: the serving path's) on both
    operands of each serve_gemms GEMM against quantize_ref, and K3 on those
    codes against mls_matmul_ref on the plan matmul_plan picks and on every
    other variant it accepts (k3_plans); the rows serve_gemms marks timed
    (the plain versions on 3 calls), each beside the other plans and
    torch._int_mm (k3_times)."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_matmul import sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(7)
    checks = []
    for sname, (M, K, N, timing) in serve_gemms().items():
        x = torch.randn((M, K), generator=gen, device="cuda")
        wt = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        operands = {"x": x, "w^T": wt}
        coded = {}
        for oname, t in operands.items():
            r = rounding_bytes(t.shape, None, t.device)
            got = mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            want = quantize_ref(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            checks.append(dict(kernel="mls_quantize_rows", shape=f"serve {sname} {oname}",
                               operand=tuple(t.shape), identical=all(
                                   torch.equal(a, b) for a, b in zip(got, want)),
                               max_abs_err=err))
            run = lambda t=t, r=r: mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")  # noqa: E731
            if timing:
                timed[("mls_quantize_rows", sname, oname)] = dict(
                    ms=cuda_ms(run),
                    kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_rows"]),
                    plain_ms=cuda_ms(lambda t=t, r=r: quantize_ref(t, fmt, kb, GS_FMT_DEFAULT,
                                                                   r, "nc"), iters=3, warmup=1),
                    # x read, codes and scales written: nearest rounding needs
                    # no rounding byte, though the wrapper reads a constant one
                    bytes=t.numel() * 5 + got[1].numel() * 4 + 4, ops=0, max_abs_err=err,
                    shape=f"serve {sname} {oname} {tuple(t.shape)}")
            coded[oname] = got
        (xc, xsg, xst), (wc, wsg, wst) = coded["x"], coded["w^T"]
        args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        want = mls_matmul_ref(*args)
        plans = k3_plans(M, N, K, kb, fmt)
        plan = plans[0]
        errs = []
        for p in plans:
            got = mls_matmul(*args, "nc", plan=p)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
            checks.append(dict(kernel="mls_matmul", shape=f"serve {sname}", mkn=(M, K, N),
                               plan=dataclasses.asdict(p), chosen=p == plan,
                               identical=torch.equal(got, want),
                               max_abs_err=max_abs_err(got, want),
                               finite=bool(torch.isfinite(got).all())))
        xs_shape, ws_shape = sg_shapes("nc", M, N, K // kb)
        run = lambda p: lambda: mls_matmul(*args, "nc", plan=p)  # noqa: E731
        if timing:
            timed[("mls_matmul", sname)] = dict(
                ms=cuda_ms(run(plan)),
                kernel_ms=kernel_ms(run(plan), DEVICE_KERNELS["mls_matmul"]),
                **k3_times(args, "nc", plans),
                plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                + 4 * M * N + 8, ops=2 * M * N * K, max_abs_err=errs[0],
                plan=dataclasses.asdict(plan),
                shape=f"serve {sname} ({M}x{K}x{N}) {plan.variant}")
        del x, wt, coded, args, want, got
        torch.cuda.empty_cache()
    return checks


def weight_requant_ms() -> dict:
    """What re-coding chatglm3-6b's weights costs per serving step, as
    qd_gemm does it on every call: for each of one layer's 7 weights (K, N)
    its transposed fp32 copy (``F.pad(w.float().t(), (0, pk)).contiguous()``,
    pk = 0 here), the nearest-rounding byte fill and K1 on the (N, K) copy,
    each timed by CUDA events; per layer and times the 28 layers."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_quantize, rounding_bytes

    cfg = dataclasses.replace(get_config("chatglm3-6b"), quant_backend="pallas")
    d, kv, f = cfg.d_model, cfg.n_kv_heads * cfg.hd, cfg.d_ff
    shapes = [(d, cfg.n_heads * cfg.hd), (d, kv), (d, kv), (cfg.n_heads * cfg.hd, d), (d, f),
              (d, f), (f, d)]
    gen = torch.Generator(device="cuda").manual_seed(8)
    layer = dict(copy_ms=0.0, fill_ms=0.0, k1_ms=0.0, elements=0)
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        wt = F.pad(w.float().t(), (0, (-K) % K_BLOCK)).contiguous()
        r = rounding_bytes(wt.shape, None, wt.device)
        layer["copy_ms"] += cuda_ms(lambda: F.pad(w.float().t(), (0, (-K) % K_BLOCK)).contiguous())
        layer["fill_ms"] += cuda_ms(lambda: rounding_bytes(wt.shape, None, wt.device))
        layer["k1_ms"] += cuda_ms(lambda: mls_quantize(wt, FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT,
                                                       r, "nc"))
        layer["elements"] += K * N
        del w, wt, r
    torch.cuda.empty_cache()
    return dict(per_layer=layer, layers=cfg.n_layers,
                per_step={k: v * cfg.n_layers for k, v in layer.items()})


def serve_card_vs_cpu() -> dict:
    """A smoke config of each family (fp32, quantized kernels) with the same
    weights on the CPU (plain versions) and on the card: prefill and 8
    decode logits, the greedy tokens, and the card's launches against the
    closed form (the encoder-decoder's prompts carry 12 source frames)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import ServeEngine

    out = {}
    for name in SERVE_MODELS:
        cfg = dataclasses.replace(get_smoke_config(name), quant_backend="pallas")
        cpu = init_lm(cfg, seed=3, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        gen = torch.Generator().manual_seed(4)
        toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
        prompts = lm_inputs(cfg, toks[:, :4], gen, 12)
        n = serve_linears(cfg, prefill=True) + 8 * serve_linears(cfg)
        logits, tokens = {}, {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            engine = ServeEngine(cfg, model, max_len=32, device=dev)
            reset_launch_counts()
            with torch.inference_mode():
                lg, cache = engine.prefill(prompts)
                steps = [lg]
                for i in range(4, 12):
                    lg, cache = engine.decode(cache, toks[:, i:i + 1].to(dev))
                    steps.append(lg)
            launched = launch_counts()
            logits[dev] = torch.stack(steps).cpu()
            tokens[dev] = engine.generate(prompts, 8).cpu()
        err = max_abs_err(logits["cuda"], logits["cpu"])
        scale = max(1.0, float(logits["cpu"].abs().max()))
        out[name] = dict(logits_max_abs=err, tolerance=SERVE_AGREE_TOL * scale,
                         tokens_equal=torch.equal(tokens["cuda"], tokens["cpu"]),
                         card_launches={k: launched[k] for k in ("mls_quantize_rows",
                                                                 "mls_matmul")})
        out[name]["agree"] = (err <= SERVE_AGREE_TOL * scale and out[name]["tokens_equal"]
                              and out[name]["card_launches"] == {"mls_quantize_rows": 2 * n,
                                                                 "mls_matmul": n})
    return out


# card against CPU on the smoke configs: the quantized linears are
# bit-exact, but the norms, attention and SSD sums reduce in other orders
# on the card, and one ulp before a quantizer can move an element to the
# neighbouring code (the CPU cross-tests against the JAX package hold the
# same logits to this bound)
SERVE_AGREE_TOL = 1e-3


def phase_serve(results: dict) -> dict[str, dict[str, int]]:
    """The LM serving path: SERVE_MODELS at full width on the card, K1 and
    K3 at the serving GEMMs, and card against CPU on the smoke configs.
    Returns each model's launches of its whole ``generate`` by kernel (the
    counts set to 0 just before that run and read just after it)."""
    smi = results["nvidia_smi"]
    served = {name: serve_model(name, smi) for name in SERVE_MODELS}
    timed: dict = {}
    checks = serve_kernel_checks(timed)
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         **{k: v for k, v in t.items() if k not in ("bytes", "ops")}))
        print(json.dumps({"serve_timing": rows[-1], "nvidia_smi": smi}))
    requant = weight_requant_ms()
    print(json.dumps({"serve_weight_requant_chatglm3": requant, "nvidia_smi": smi}))
    agree = serve_card_vs_cpu()
    print(json.dumps({"serve_agree": agree}))
    results["serve"] = dict(models=served, kernel_checks=checks, kernel_times=rows,
                            weight_requant=requant, agree=agree)
    bad = [c for c in checks if not c["identical"]]
    if bad:
        raise AssertionError(f"{len(bad)} serving-shape kernel results differ from their plain "
                             f"versions: {bad[:3]}")
    if not all(a["agree"] for a in agree.values() if a.get("held", True)):
        raise AssertionError(f"card and CPU disagree on the smoke configs: {agree}")
    return {name: r["launches_generate"] for name, r in served.items()}


# The lm_train phase: LM training (repro_torch.train.make_train_step) on the
# quantized kernels, quant_backend "pallas" (K1 on both operands and K3 for
# the forward, data-gradient and weight-gradient GEMM of every linear),
# stochastic rounding from fold_in(seed, step), bf16 compute and full remat
# as the FULL configs say, AdamW with the default cosine schedule (lr 0 at
# step 0), random weights from seed 0, train_4k's sequence (the
# encoder-decoder's encoder reads as many random frontend frames).
# name: (config overrides, batch, seq)
LM_TRAIN_STEPS = 4
LM_TRAIN_MODELS = {
    "chatglm3-6b": ({"n_layers": 4}, 2, 4096),
    "mamba2-370m": ({}, 4, 1024),
    "zamba2-7b": ({"n_layers": 12}, 2, 4096),
    "moonshot-v1-16b-a3b": ({"n_layers": 2}, 1, 4096),
    "seamless-m4t-medium": ({"n_layers": 6, "enc_layers": 6}, 2, 4096),
}
LM_TRAIN_CUTS = {
    "chatglm3-6b": "n_layers 28 -> 4 (all 28 with AdamW's state take ~100 GB; 8 until "
                   "sequence parallelism took the time); train_4k's global batch 256 -> 2 "
                   "(seq 4096)",
    "mamba2-370m": "train_4k's global batch 256 -> 4, seq 4096 -> 1024",
    "zamba2-7b": "n_layers 81 -> 12 (2 shared-block applications); train_4k's global batch "
                 "256 -> 2 (seq 4096)",
    "moonshot-v1-16b-a3b": "n_layers 48 -> 2 (at 4, 2.95 G parameters: 47 GB with AdamW's "
                           "16 B each; 4 until sequence parallelism took the time); "
                           "train_4k's global batch 256 -> 1 (seq 4096): at 2 the fp32 "
                           "logits over its 163840-word vocabulary (5.4 GB a copy, about 4 "
                           "live) would take the card past 80 GB",
    "seamless-m4t-medium": "train_4k's global batch 256 -> 2 (seq 4096, 4096 source frames); "
                           "12 + 12 layers -> 6 + 6 (whole until sequence parallelism took "
                           "the time)",
}
# the model whose run is checkpointed after step 2 and resumed
LM_TRAIN_CKPT = "mamba2-370m"


def lm_train_data(cfg, batch: int, seq: int):
    """The run's LM token stream on the card; the encoder-decoder's batches
    also carry ``src_emb`` (batch, seq, frontend_dim) for its encoder."""
    from repro_torch.data import make_lm_iterator

    extras = ((("src_emb", (batch, seq, cfg.frontend_dim)),) if cfg.family == "encdec"
              else ())
    return make_lm_iterator(batch, seq, cfg.vocab, extras=extras, device="cuda")


def _device_ms_by_name(prof) -> dict[str, float]:
    """Device ms by kernel name (the GPU annotations of the MoE experts'
    spans, core.lowbit.STACK_SPANS, left out)."""
    from torch.autograd import DeviceType

    from repro_torch.core.lowbit import STACK_SPANS

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in STACK_SPANS:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def _experts_ms(prof) -> float:
    """Device ms of the MoE experts' fake-quant in a trace: the kernels
    that run inside the GPU annotations of core.lowbit.STACK_SPANS, the
    stacked fake-quant GEMM's forward and backward (one stream: the kernels
    between a span's first and last are its own).  The profiler's "CUDA
    total" of the spans' host ranges over-counts: it read 1253 ms for
    llama4-scout's decode step against 1142 ms of device busy (H100)."""
    from torch.autograd import DeviceType

    from repro_torch.core.lowbit import STACK_SPANS

    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (spans if e.name in STACK_SPANS else kernels).append(e.time_range)
    return sum(k.elapsed_us() for k in kernels
               if any(s.start <= k.start < s.end for s in spans)) / 1e3


def traced_train_step(step_fn, model, opt, batch) -> tuple:
    """One train step under torch.profiler: the host-clock step, device busy
    (the sum of kernel times), K1's and K3's kernel time, copies (the
    transposed operands qd_gemm makes contiguous, among others), the MoE
    experts' fake-quant (forward, its remat and backward: _experts_ms) and
    the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    of = lambda names: sum(v for k, v in by_name.items()  # noqa: E731
                           if any(n.lower() in k.lower() for n in names))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    trace = dict(host_ms_under_profiler=host_ms, device_ms=device_ms,
                 k1_ms=of(DEVICE_KERNELS["mls_quantize_rows"]),
                 k3_ms=of(DEVICE_KERNELS["mls_matmul"]),
                 copy_ms=of(("copy", "Memcpy")), softmax_ms=of(("softmax",)),
                 experts_ms=_experts_ms(prof), device_idle_share=1.0 - device_ms / host_ms,
                 top_kernels_ms=[(k[:90], v) for k, v in top],
                 finite=bool(torch.isfinite(m["loss"])))
    return model, opt, trace


def lm_component_ms(cfg, batch: int, seq: int) -> dict:
    """The step's attention and LM head timed alone at its shapes (CUDA
    events, fresh random tensors): one attention forward, one forward and
    backward; the LM head with the loss forward and backward.  Per step,
    every attention use (an encoder-decoder's decoder layer has two) runs
    forward and backward, and under full remat its forward once more (the
    hybrid's shared block is not remat'd).  For an MoE, one layer's routed
    experts alone (the three stacked fake-quant GEMMs and the gate, at the
    dispatch's (E, B x capacity, d) rows), forward and forward + backward,
    likewise times the layers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import torch_dtype
    from repro_torch.core import fold_in
    from repro_torch.core.lowbit import lowbit_matmul_stack
    from repro_torch.models import nn as L

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    if cfg.n_heads:
        q = torch.randn((batch, seq, cfg.n_heads, cfg.hd), generator=gen, device="cuda")
        k, v = (torch.randn((batch, seq, cfg.n_kv_heads, cfg.hd), generator=gen, device="cuda")
                for _ in range(2))
        qkv = [t.requires_grad_() for t in (q, k, v)]
        g = torch.randn_like(q)
        fwd = cuda_ms(lambda: L.gqa_attention(*qkv), iters=3, warmup=1)
        both = cuda_ms(lambda: torch.autograd.grad(L.gqa_attention(*qkv), qkv, g), iters=3,
                       warmup=1)
        uses = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                "encdec": cfg.enc_layers + 2 * cfg.n_layers}.get(cfg.family, cfg.n_layers)
        remat_fwd = uses if cfg.family != "hybrid" and cfg.remat == "full" else 0
        out.update(attention_fwd_ms=fwd, attention_fwd_bwd_ms=both, attention_uses=uses,
                   attention_ms_per_step=uses * both + remat_fwd * fwd)
        del q, k, v, qkv, g
    if cfg.family == "moe":
        e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        rows = batch * int(seq * cfg.top_k / e * cfg.capacity_factor + 1)
        xe = torch.randn((e, rows, d), generator=gen, device="cuda").to(
            torch_dtype(cfg.compute_dtype)).requires_grad_()
        ws = [(torch.randn(shape, generator=gen, device="cuda") * 0.02).requires_grad_()
              for shape in ((e, d, f), (e, d, f), (e, f, d))]
        qcfg, key = cfg.qcfg(), 12345

        def experts():
            g = lowbit_matmul_stack(xe, ws[0], fold_in(key, 0), qcfg)
            u = lowbit_matmul_stack(xe, ws[1], fold_in(key, 1), qcfg)
            h = (F.silu(g) * u).to(xe.dtype)
            return lowbit_matmul_stack(h, ws[2], fold_in(key, 2), qcfg)

        gy = torch.randn((e, rows, d), generator=gen, device="cuda")
        fwd = cuda_ms(experts, iters=3, warmup=1)
        both = cuda_ms(lambda: torch.autograd.grad(experts(), [xe] + ws, gy), iters=3, warmup=1)
        remat_fwd = cfg.n_layers if cfg.remat == "full" else 0
        out.update(experts_fwd_ms=fwd, experts_fwd_bwd_ms=both, experts_rows=(e, rows, d),
                   experts_ms_per_step=cfg.n_layers * both + remat_fwd * fwd)
        del xe, ws, gy
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda").to(
        torch_dtype(cfg.compute_dtype)).requires_grad_()
    head = (torch.randn((cfg.vocab, cfg.d_model), generator=gen, device="cuda") * 0.02
            ).requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device="cuda")

    def head_and_loss():
        logits = x.float() @ head.to(x.dtype).float().t()  # lm.logits_fn
        lg = logits[:, :-1]
        ll = torch.gather(lg, -1, tokens[:, 1:, None])[..., 0]
        loss = (torch.logsumexp(lg, dim=-1) - ll).mean()
        return torch.autograd.grad(loss, (x, head))

    out["lm_head_and_loss_fwd_bwd_ms"] = cuda_ms(head_and_loss, iters=3, warmup=1)
    del x, head, tokens
    torch.cuda.empty_cache()
    return out


def lm_train_model(name: str, smi: str) -> dict:
    """Train one of LM_TRAIN_MODELS for LM_TRAIN_STEPS steps at full width:
    counts set to 0 just before the run and read just after; each step's
    launches, loss, grad norm and host time (train_step alone: its batch is
    drawn first, and that time kept apart); the weights unchanged by step
    1 (lr 0) and moved by step 2; one more step traced; chatglm3-6b also a
    step at microbatch 2; LM_TRAIN_CKPT checkpointed after step 2 on the
    card, restored on the card and resumed, its step 3 equal bit for bit."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import SHAPES, RunConfig, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.train import CheckpointManager, make_train_step

    over, batch, seq = LM_TRAIN_MODELS[name]
    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
    if cfg.remat != "full" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{name}: expected full remat and bf16 compute, got {cfg.remat}, "
                             f"{cfg.compute_dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"])
    step_fn, opt_init = make_train_step(run)
    model = init_lm(cfg, seed=0, device="cuda")
    opt = opt_init(model)
    data = lm_train_data(cfg, batch, seq)
    params = dict(model.named_parameters())
    watched = ("emb", "layers.0." + ("in_proj.w" if cfg.family in ("ssm", "hybrid")
                                     else "attn.wq.w"))
    before_run = {k: params[k].detach().clone() for k in watched}
    want = lm_train_launches(cfg)
    ckpt_dir = tempfile.TemporaryDirectory() if name == LM_TRAIN_CKPT else None
    losses, gnorms, lrs, steps_ms, data_ms, per_step, moved, bad = [], [], [], [], [], [], [], []
    step3 = None

    reset_launch_counts()
    for i in range(LM_TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = next(data)  # drawn on the host and put on the card
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, opt, m = step_fn(model, opt, inputs)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        data_ms.append((t1 - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        per_step.append({k: launch_counts()[k] - before[k] for k in want})
        moved.append([not torch.equal(before_run[k], params[k]) for k in watched])
        if ckpt_dir is not None and i == 1:
            CheckpointManager(ckpt_dir.name).save(
                i + 1, {"params": model.state_dict(), "opt": opt, "data": data.state_dict()})
        if ckpt_dir is not None and i == 2:
            step3 = (losses[-1], {k: p.detach().clone() for k, p in params.items()})
    torch.cuda.synchronize()
    launched = launch_counts()
    k3_variants = k3_launches_by_variant()
    # the steps' peak, and what the run holds beside them there: the watched
    # weights' copies and, from step 3 on, the checkpointed model's
    steps_peak = torch.cuda.max_memory_allocated()
    held = [*before_run.values(), *(step3[1].values() if step3 is not None else ())]
    held_bytes = sum(t.numel() * t.element_size() for t in held)

    model, opt, trace = traced_train_step(step_fn, model, opt, next(data))
    r = dict(config={k: getattr(cfg, k) for k in ("n_layers", "d_model", "n_heads",
                                                   "n_kv_heads", "d_ff", "vocab",
                                                   "compute_dtype", "remat")},
             cut=LM_TRAIN_CUTS[name], params=sum(p.numel() for p in params.values()),
             batch=batch, seq=seq, tokens_per_step=batch * seq, losses=losses,
             grad_norms=gnorms, lrs=lrs, steps_ms=steps_ms, data_ms=data_ms,
             median_step_ms=statistics.median(steps_ms[1:]), launches_per_step=per_step,
             steps_peak_memory_bytes=steps_peak, held_beside_steps_bytes=held_bytes,
             expected_per_step=want, launches=launched, k3_variants=k3_variants,
             weights_moved=moved, trace=trace, nvidia_smi=smi)
    if name == "chatglm3-6b":  # the same run, one step at microbatch 2
        mb_fn, _ = make_train_step(dataclasses.replace(run, microbatch=2))
        before = launch_counts()
        model, opt, m = mb_fn(model, opt, next(data))
        r["microbatch2"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                launches={k: launch_counts()[k] - before[k] for k in want},
                                expected=lm_train_launches(cfg, microbatch=2))
        if not math.isfinite(r["microbatch2"]["loss"]):
            bad.append(f"microbatch-2 loss {r['microbatch2']['loss']}")
        if r["microbatch2"]["launches"] != r["microbatch2"]["expected"]:
            bad.append(f"microbatch-2 launches {r['microbatch2']['launches']}")
        r["remat_dots"] = remat_dots_vs_full(model, next(data))
        if not r["remat_dots"]["same_bits"]:
            bad.append(f"remat dots differs from full: {r['remat_dots']}")
        model, opt, r["k3_walk_vs_wgmma"] = walk_vs_wgmma_steps(step_fn, model, opt, data, cfg)
        print(f"lm_train {name}: train_step with K3 on the walk / its default plans (wgmma): "
              f"{json.dumps(r['k3_walk_vs_wgmma'])}")
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model, opt, params, before_run, m
    torch.cuda.empty_cache()
    if ckpt_dir is not None:  # a fresh run restored from step 2 on the card
        model = init_lm(cfg, seed=1, device="cuda")
        opt = opt_init(model)
        data = lm_train_data(cfg, batch, seq)
        mgr = CheckpointManager(ckpt_dir.name)
        st = mgr.restore({"params": model.state_dict(), "opt": opt,
                          "data": data.state_dict()}, device="cuda")
        model.load_state_dict(st["params"])
        data.load_state_dict(st["data"])
        model, _, m = step_fn(model, st["opt"], next(data))
        same = float(m["loss"]) == step3[0] and all(
            torch.equal(p, step3[1][k]) for k, p in model.named_parameters())
        r["resume"] = dict(from_step=mgr.latest_step(), resumed_loss=float(m["loss"]),
                           uninterrupted_loss=step3[0], bit_identical=same)
        if not same:
            bad.append(f"the resumed step 3 differs from the uninterrupted one: {r['resume']}")
        del model, opt, st, step3
        ckpt_dir.cleanup()
        torch.cuda.empty_cache()
    r["components"] = lm_component_ms(cfg, batch, seq)
    print(f"lm_train {name} ({smi}): {r['params'] / 1e9:.3f} G params, losses {losses}, grad "
          f"norms {gnorms}, steps {[round(t, 1) for t in steps_ms]} ms (batches drawn in "
          f"{[round(t, 2) for t in data_ms]} ms before them), device busy "
          f"{trace['device_ms']:.1f} ms of {trace['host_ms_under_profiler']:.1f} (idle "
          f"{trace['device_idle_share']:.3f}), K1 {trace['k1_ms']:.1f} ms, K3 "
          f"{trace['k3_ms']:.1f} ms (launches by variant {k3_variants}), copies "
          f"{trace['copy_ms']:.1f} ms, experts' fake-quant "
          f"{trace['experts_ms']:.1f} ms, peak "
          f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches per step {per_step[0]}; "
          f"reduced: {r['cut']}")
    if not all(math.isfinite(v) for v in losses + gnorms) or not trace["finite"]:
        bad.append(f"non-finite loss or grad norm: {losses} {gnorms}")
    if any(moved[0]) or not all(moved[1]):
        bad.append(f"weights moved {moved}: expected none after step 1 (lr 0), all after 2")
    if any(p != want for p in per_step):
        bad.append(f"launches per step {per_step}, expected {want}")
    if name in LM_TRAIN_WGMMA and not k3_variants.get("wgmma"):
        bad.append(f"K3 never ran its wgmma variant: {k3_variants}")
    if {k: launched[k] for k in want} != {k: v * LM_TRAIN_STEPS for k, v in want.items()}:
        bad.append(f"the run launched {launched}, expected {want} x {LM_TRAIN_STEPS}")
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    return r


def walk_vs_wgmma_steps(step_fn, model, opt, data, cfg) -> tuple:
    """train_step (alone, its batch drawn first) with K3 on the walk at every
    GEMM of the step (the seed tile cache with each of the step's gemm keys
    set to the walk) and on the plans it resolves by default (the wgmma
    variant), in turns walk, default, default, walk: K3's wgmma variant's
    share of the step, measured in one call.  Returns the model, the
    optimizer and {"walk_ms", "default_ms"}."""
    import dataclasses

    import torch

    from repro_torch.kernels import autotune as at

    qcfg = dataclasses.replace(cfg, quant_backend="pallas").qcfg()
    walk = at.TuneCache(device=at.device_name("cuda"))
    walk.entries = dict(at.get_cache().entries)
    for label, (M, K, N, _) in lm_train_gemms().items():
        if label.startswith(cfg.name + " "):
            walk.put(at.TuneSpec("gemm", (M, K, N), qcfg.fmt, qcfg.k_block, qcfg.grouping),
                     at.BlockConfig("walk", 16 if N <= 16 else 32 if N <= 32 else 64), 0.0)
    out = {"walk_ms": [], "default_ms": []}
    for which in ("walk", "default", "default", "walk"):
        inputs = next(data)
        with at.override_cache(walk) if which == "walk" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, _ = step_fn(model, opt, inputs)
            torch.cuda.synchronize()
        out[f"{which}_ms"].append((time.perf_counter() - t0) * 1e3)
    return model, opt, out


def remat_dots_vs_full(model, batch: dict) -> dict:
    """One lm_loss forward and backward (key 7) of ``model`` under remat
    "full", then "dots": the loss and the gradients' norm must be the same
    bits (under the kernels K3 is recomputed either way); each one's ms
    (host clock after a sync) and peak device memory."""
    import dataclasses

    import torch

    from repro_torch.models.lm import lm_loss

    cfg, out = model.cfg, {}
    for remat in ("full", "dots"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = lm_loss(model, batch, 7)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gnorm = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(p.grad.float()) for p in model.parameters()
            if p.grad is not None]))
        out[remat] = dict(loss=float(loss), grad_norm=float(gnorm), ms=ms,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del loss
    model.cfg = cfg
    model.zero_grad(set_to_none=True)
    out["same_bits"] = (out["full"]["loss"] == out["dots"]["loss"]
                        and out["full"]["grad_norm"] == out["dots"]["grad_norm"])
    print(f"lm_train remat dots vs full: {json.dumps(out)}")
    return out


# K1 (stochastic, given bytes) and K3 are held to their plain versions at
# every training GEMM of the lm_train phase's models, each at its run's T =
# batch x seq tokens: for a quantized linear K -> N its forward (T, K, N),
# data gradient (T, N, K) and weight gradient (K, T, N), contracting over
# the tokens (T/128 scaling groups) with both operands transposed copies in
# qd_gemm.  The rows of LM_TRAIN_TIMED are also timed.
LM_TRAIN_TIMED = "chatglm3-6b"
# the models whose training step must run K3's wgmma variant (the seed tile
# cache and matmul_plan pick it at their large GEMMs)
LM_TRAIN_WGMMA = ("chatglm3-6b", "zamba2-7b")


def k3_launches_by_variant() -> dict[str, int]:
    """K3's launches on the card since the last reset, by plan variant
    (from the launch records: the plan is one of each record's arguments)."""
    from repro_torch.kernels import launch

    out: dict[str, int] = {}
    for key, n in launch.RECORDED.items():
        if key[0] == "mls_matmul" and key[1] == "cuda":
            out[key[-1].variant] = out.get(key[-1].variant, 0) + n
    return out


def lm_train_gemms() -> dict[str, tuple]:
    """{label: (M, K, N, kind)}: the distinct (M, K, N) of every quantized
    linear of the LM_TRAIN_MODELS configs (as cut), read from the model
    built on the meta device; K is the contraction before qd_gemm pads it
    to K_BLOCK."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import nn as L
    from repro_torch.models.lm import LM

    out, seen = {}, set()
    for name, (over, batch, seq) in LM_TRAIN_MODELS.items():
        cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
        with torch.device("meta"):
            model = LM(cfg)
        t = batch * seq
        for mname, mod in model.named_modules():
            if (not isinstance(mod, L.Linear) or mname == "frontend_proj"
                    or mname.endswith("router")):  # unquantized
                continue
            k, n = mod.w.shape
            for kind, mkn in (("fwd", (t, k, n)), ("dgrad", (t, n, k)), ("wgrad", (k, t, n))):
                if (name, mkn) not in seen:
                    seen.add((name, mkn))
                    out[f"{name} {mname.split('.')[-1]} {kind}"] = (*mkn, kind)
    return out


def lm_train_kernel_checks(timed: dict) -> list[dict]:
    """K1 ("nc", <2,4>, stochastic: given rounding bytes to both) on both
    operands of each lm_train_gemms GEMM against quantize_ref, and K3 on
    those codes against mls_matmul_ref on the plan matmul_plan picks and on
    every other variant it accepts (k3_plans: the wgmma variant wherever it
    is legal); each operand zero-padded along K to K_BLOCK as qd_gemm pads
    it.  The LM_TRAIN_TIMED rows are timed (the plain versions on 3 calls)
    beside the other plans and torch._int_mm (k3_times), with, for the
    weight gradient, the transposed copy qd_gemm makes of each operand."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize
    from repro_torch.kernels.mls_matmul import sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(9)
    checks = []
    for sname, (M, K, N, kind) in lm_train_gemms().items():
        timing = sname.startswith(LM_TRAIN_TIMED)
        pk = (-K) % kb
        coded = {}
        for oname, rows in (("x", M), ("w^T", N)):
            if kind == "wgrad":  # the operand as the step holds it, copied transposed
                src = torch.randn((K, rows), generator=gen, device="cuda")
                t = F.pad(src.t(), (0, pk)).contiguous()
                if timing:
                    timed[("transpose_copy", sname, oname)] = dict(
                        ms=cuda_ms(lambda src=src: F.pad(src.t(), (0, pk)).contiguous()),
                        bytes=8 * src.numel(), ops=0, shape=f"lm_train {sname} {oname} "
                        f"{tuple(src.shape)}^T")
                del src
            else:
                t = F.pad(torch.randn((rows, K), generator=gen, device="cuda"), (0, pk))
            r = torch.randint(0, 256, t.shape, generator=gen, dtype=torch.uint8, device="cuda")
            got = mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            want = quantize_ref(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            checks.append(dict(kernel="mls_quantize_rows", shape=f"lm_train {sname} {oname}",
                               operand=tuple(t.shape), identical=all(
                                   torch.equal(a, b) for a, b in zip(got, want)),
                               max_abs_err=err))
            run = lambda t=t, r=r: mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")  # noqa: E731
            if timing:
                timed[("mls_quantize_rows", sname, oname)] = dict(
                    ms=cuda_ms(run),
                    kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_rows"]),
                    plain_ms=cuda_ms(lambda t=t, r=r: quantize_ref(t, fmt, kb, GS_FMT_DEFAULT,
                                                                   r, "nc"), iters=3, warmup=1),
                    # x and its rounding bytes read, codes and scales written
                    bytes=t.numel() * 6 + got[1].numel() * 4 + 4, ops=0, max_abs_err=err,
                    shape=f"lm_train {sname} {oname} {tuple(t.shape)}")
            coded[oname] = got
            del t, r, want
        (xc, xsg, xst), (wc, wsg, wst) = coded["x"], coded["w^T"]
        args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        want = mls_matmul_ref(*args)
        plans = k3_plans(M, N, K + pk, kb, fmt)
        plan = plans[0]
        errs = []
        for p in plans:
            got = mls_matmul(*args, "nc", plan=p)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
            checks.append(dict(kernel="mls_matmul", shape=f"lm_train {sname}", mkn=(M, K, N),
                               plan=dataclasses.asdict(p), chosen=p == plan,
                               identical=torch.equal(got, want), max_abs_err=errs[-1],
                               finite=bool(torch.isfinite(got).all())))
            del got
        if timing:
            xs_shape, ws_shape = sg_shapes("nc", M, N, (K + pk) // kb)
            run = lambda p: lambda: mls_matmul(*args, "nc", plan=p)  # noqa: E731
            timed[("mls_matmul", sname)] = dict(
                ms=cuda_ms(run(plan)),
                kernel_ms=kernel_ms(run(plan), DEVICE_KERNELS["mls_matmul"]),
                **k3_times(args, "nc", plans),
                plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                bytes=(M + N) * (K + pk) + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                + 4 * M * N + 8, ops=2 * M * N * (K + pk), max_abs_err=errs[0],
                plan=dataclasses.asdict(plan),
                shape=f"lm_train {sname} ({M}x{K}x{N}) {plan.variant}")
            if plan.variant == "wgmma":  # its decode pass alone
                timed[("mls_matmul", sname)]["decode_kernel_ms"] = kernel_ms(
                    run(plan), "mls_matmul_decode")
        del coded, args, want
        torch.cuda.empty_cache()
    return checks


# card against CPU on smoke configs (lm_loss and its gradients, key None,
# fp32): without quantization only the sums' order differs (1e-4 relative
# for the loss and each gradient's L2 norm); on the kernels one ulp before a
# quantizer can move an element to the neighbouring code, which moves a
# gradient by up to a few percent (the CPU cross-tests saw 1.6% on one
# weight against the JAX package), so there 1e-4 for the loss and 5e-2 per
# gradient.  With every quantizer fed the CPU's operands no code can move,
# so the card is held to the unquantized bound ("pallas fed").
LM_TRAIN_AGREE = {"off": (1e-4, 1e-4), "pallas": (1e-4, 5e-2), "pallas fed": (1e-4, 1e-4)}
# Seeds at which the new families' unfed gap is read (twice each) and
# reported: one code moved early cascades through every later quantizer,
# so that gap is ~1e-6 at most seeds and percents at a few.  It is held
# to "pallas" for every family but the encoder-decoder, whose smoke config
# moves 5.4% at seed 3 (PERF.md); that one is held through its fed run.
UNFED_SEEDS = (3, 4, 5, 6, 7)


class fed_operands:
    """Within: every quantizer of the LM's linears (``qd_gemm``'s two
    operands, ``quantize_stack``'s one) appends its operands to ``ops``
    as CPU copies or, with ``feed``, takes the next ones of ``ops`` in
    their place (those of the same work run before, on any device)."""

    def __init__(self, ops: list, feed: bool):
        from repro_torch.core import lowbit
        from repro_torch.kernels import lowbit_conv

        self.ops, self.feed, self.used = ops, feed, 0
        self.sites = [(lowbit_conv, "qd_gemm", 2), (lowbit, "quantize_stack", 1)]
        self.real = [getattr(mod, attr) for mod, attr, _ in self.sites]

    def _spy(self, attr: str, n: int, real):
        def spy(*args, **kwargs):
            head = args[:n]
            if self.feed:
                tag, fed = self.ops[self.used]
                self.used += 1
                if tag != attr or [t.shape for t in fed] != [t.shape for t in head]:
                    raise RuntimeError(f"fed_operands: call {self.used} is {attr} "
                                       f"{[tuple(t.shape) for t in head]}, the record's {tag}")
                head = tuple(t.to(h.device) for t, h in zip(fed, head))
            else:
                self.ops.append((attr, tuple(t.detach().cpu().clone() for t in head)))
            return real(*head, *args[n:], **kwargs)
        return spy

    def __enter__(self):
        for (mod, attr, n), real in zip(self.sites, self.real):
            setattr(mod, attr, self._spy(attr, n, real))
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), real in zip(self.sites, self.real):
            setattr(mod, attr, real)
        if exc[0] is None and self.feed and self.used != len(self.ops):
            raise RuntimeError(f"fed_operands: {self.used} of {len(self.ops)} recorded calls made")


def lm_card_vs_cpu(name: str, backend: str, seed: int = 3, fed: bool = False) -> dict:
    """lm_loss and its gradients with key None, the same weights (from
    ``seed``) and batch (from ``seed + 1``) on the CPU (plain versions)
    and on the card, for the smoke config of ``name``; with ``fed`` every
    quantizer on the card takes the CPU run's operands (fed_operands)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm

    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    cpu = lm.init_lm(cfg, seed=seed, device="cpu")
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
    gen = torch.Generator().manual_seed(seed + 1)
    batch = lm_inputs(cfg, torch.randint(0, cfg.vocab, (2, 32), generator=gen), gen, 32)
    ops: list = []
    res = {}
    for dev, model in models.items():
        reset_launch_counts()
        with fed_operands(ops, feed=dev == "cuda") if fed else contextlib.nullcontext():
            loss, _ = lm.lm_loss(model, {k: v.to(dev) for k, v in batch.items()}, None)
            loss.backward()
        res[dev] = (float(loss.detach()),
                    {k: p.grad.cpu() for k, p in model.named_parameters()})
        if dev == "cuda":
            launched = launch_counts()
    rel = {k: float((res["cuda"][1][k] - g).double().norm()
                    / max(float(g.double().norm()), 1e-30))
           for k, g in res["cpu"][1].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    want = lm_train_launches(cfg) if backend == "pallas" else {
        "mls_quantize_rows": 0, "mls_matmul": 0}
    loss_tol, grad_tol = LM_TRAIN_AGREE[f"{backend} fed" if fed else backend]
    return dict(loss_cpu=res["cpu"][0], loss_cuda=res["cuda"][0], loss_rel=loss_rel,
                worst_grad_rel=rel[worst], worst_grad=worst, tolerance=(loss_tol, grad_tol),
                fed_calls=len(ops), card_launches={k: launched[k] for k in want},
                agree=loss_rel <= loss_tol and rel[worst] <= grad_tol
                and {k: launched[k] for k in want} == want)


def lm_train_card_vs_cpu() -> dict:
    """:func:`lm_card_vs_cpu` for the smoke configs of LM_TRAIN_MODELS on
    the kernels, as run and fed, and of chatglm3-6b unquantized; for the
    families this phase added (moe, encdec) the unfed gap at UNFED_SEEDS,
    read twice."""
    from repro_torch.configs import get_smoke_config

    out = {}
    for name in LM_TRAIN_MODELS:
        family = get_smoke_config(name).family
        out[f"{name} pallas"] = res = lm_card_vs_cpu(name, "pallas")
        out[f"{name} pallas fed"] = lm_card_vs_cpu(name, "pallas", fed=True)
        if family in ("moe", "encdec"):
            res["unfed_by_seed"] = {
                seed: [lm_card_vs_cpu(name, "pallas", seed)["worst_grad_rel"] for _ in range(2)]
                for seed in UNFED_SEEDS}
        res["held"] = family != "encdec"  # the encoder-decoder's is reported only
    out["chatglm3-6b off"] = lm_card_vs_cpu("chatglm3-6b", "off")
    return out


def phase_lm_train(results: dict) -> dict[str, dict[str, int]]:
    """LM training: LM_TRAIN_MODELS at full width on the card, K1 and K3 at
    chatglm3-6b's training GEMMs, and card against CPU on the smoke configs.
    Returns each model's launches of its LM_TRAIN_STEPS-step run by kernel
    (the counts set to 0 just before that run and read just after it)."""
    smi = results["nvidia_smi"]
    trained = {name: lm_train_model(name, smi) for name in LM_TRAIN_MODELS}
    timed: dict = {}
    checks = lm_train_kernel_checks(timed)
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         **{k: v for k, v in t.items() if k not in ("bytes", "ops")}))
        print(json.dumps({"lm_train_timing": rows[-1], "nvidia_smi": smi}))
    agree = lm_train_card_vs_cpu()
    print(json.dumps({"lm_train_agree": agree}))
    results["lm_train"] = dict(models=trained, kernel_checks=checks, kernel_times=rows,
                               agree=agree)
    bad = [c for c in checks if not c["identical"]]
    if bad:
        raise AssertionError(f"{len(bad)} training-shape kernel results differ from their "
                             f"plain versions: {bad[:3]}")
    if not all(a["agree"] for a in agree.values() if a.get("held", True)):
        raise AssertionError(f"card and CPU disagree on the smoke configs: {agree}")
    return {name: r["launches"] for name, r in trained.items()}


# The dry run's production cells (phase dryrun): the dense arch on one pod,
# the MoE on two, at full depth.
DRYRUN_CELLS = (("chatglm3-6b", False), ("moonshot-v1-16b-a3b", True))
# ... and serving under the model axis: chatglm3-6b's prefill and decode at
# 16x16, traced on fake cuda tensors and on fake cpu ones (equal records)
DRYRUN_SERVE_CELLS = (("chatglm3-6b", "prefill_32k"), ("chatglm3-6b", "decode_32k"))
# the serve phase's chatglm3-6b decode (SERVE_MODELS: batch 4, a cache of
# its prompt and SERVE_NEW tokens) traced unsharded: its predicted peak
# against the serve phase's measured one, within DRYRUN_PEAK_TOL
DRYRUN_SERVE_CALIBRATION = "chatglm3-6b"
# predicted against measured peak, relative: sound readings are within 2%;
# without the counter's model of the softmax backward's scratch chatglm3-6b
# read 0.850 and zamba2-7b 0.900
DRYRUN_PEAK_TOL = 0.05
# one real step on the card under the dry run's counter (K1/K3, as the
# lm_train models), its peak (with the counter's workspace model) against
# the allocator's
DRYRUN_REAL = ("chatglm3-6b", {"n_layers": 1, "quant_backend": "pallas"}, 2, 4096)
DRYRUN_REAL_TOL = 0.02


def dryrun_blind_spot() -> dict:
    """DRYRUN_REAL run for real on the card under the dry run's counter
    (trace_step(fake=False)): the counter's peak, which models the scratch
    of the ops listed in trace_counts.workspace_bytes, against
    max_memory_allocated over the same step (model built, step taken)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    name, over, batch, seq = DRYRUN_REAL
    cfg = dataclasses.replace(get_config(name), **over)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = dryrun.trace_step(cfg, batch, seq, 0, device="cuda", fake=False)
    torch.cuda.synchronize()
    r = dict(config=f"{name} {over} at {batch} x {seq}", counter_peak_bytes=got["peak_bytes"],
             workspace_bytes=got["peak_by_kind"].get("Workspace", 0),
             cuda_peak_bytes=torch.cuda.max_memory_allocated() - base)
    r["ratio"] = r["counter_peak_bytes"] / r["cuda_peak_bytes"]
    torch.cuda.empty_cache()
    return r


def _dryrun_job(job: tuple) -> tuple[dict, dict]:
    """One trace of the dryrun phase, in a worker process: ("lm_train",
    name) traces that LM_TRAIN_MODELS entry (its cut, batch and
    quant_backend "pallas") unsharded on fake cuda tensors; ("serve", name)
    that SERVE_MODELS entry's decode step (quant_backend "pallas", batch
    SERVE_BATCH, a cache of its prompt and SERVE_NEW tokens); ("cell",
    arch, multi_pod) runs run_cell at train_4k; ("serve_cell", arch, shape,
    device) run_cell at 16x16 on fake tensors of that device.  Returns the
    result and the kernels the worker launched (none: fake operands launch
    nothing)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun

    if job[0] == "lm_train":
        over, batch, seq = LM_TRAIN_MODELS[job[1]]
        cfg = dataclasses.replace(get_config(job[1]), quant_backend="pallas", **over)
        out = dryrun.trace_cell(cfg, batch, seq, 0, device="cuda")
    elif job[0] == "serve":
        over, prompt_len = SERVE_MODELS[job[1]]
        cfg = dataclasses.replace(get_config(job[1]), quant_backend="pallas", **over)
        out = dryrun.trace_cell(cfg, SERVE_BATCH, prompt_len + SERVE_NEW, 0, device="cuda",
                                kind="decode")
    elif job[0] == "sp_step":  # the model-2 world's SP step, laid out as its ranks lay it out
        from repro_torch.launch.mesh import make_mesh

        cfg = _tp_configs(SP_ARCH)["pallas"]
        with dryrun.fake_world(TP_AXIS):
            mesh = make_mesh((1, 1, TP_AXIS), ("pod", "data", "model"), "cuda")
            out = dryrun.trace_step(cfg, TP_BATCH, TP_SEQ, 0, mesh, device="cuda",
                                    seq_shard=True, fsdp=False)
    elif job[0] == "serve_cell":
        out = dryrun.run_cell(job[1], job[2], False, device=job[3], out_dir=str(
            ROOT / "chiprun_out" / ("torch_dryrun" if job[3] == "cuda" else "torch_dryrun_cpu")))
    else:
        out = dryrun.run_cell(job[1], "train_4k", job[2],
                              out_dir=str(ROOT / "chiprun_out" / "torch_dryrun"))
    return out, {k: n for k, n in launch_counts().items() if n}


def phase_dryrun(results: dict) -> None:
    """The dry run (repro_torch.launch.dryrun) on the card, its traces in
    worker processes side by side (a trace is host Python; _dryrun_job).
    Calibration: each of LM_TRAIN_MODELS traced unsharded on fake cuda
    tensors; its K1 and K3 launches per step (recorded by their shape-only
    path) equal to lm_train_launches, and its predicted step peak, plus
    what the lm_train run held beside its steps, within DRYRUN_PEAK_TOL of
    the peak the run measured over its steps (lm_train_model's
    steps_peak_memory_bytes; not run again).  Then run_cell on
    DRYRUN_CELLS at train_4k: a fake world of 256 / 512 ranks, the
    launcher's layout, rank 0's record (chiprun_out/torch_dryrun/).  No
    worker launches a kernel.  Then dryrun_blind_spot: a real step (K1/K3)
    under the counter against the allocator."""
    import concurrent.futures
    import dataclasses

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.kernels.autotune import modelled_card
    from repro_torch.launch.roofline import HBM_BYTES

    smi = results["nvidia_smi"]
    measured = results["lm_train"]["models"]
    jobs = [("cell", arch, multi) for arch, multi in DRYRUN_CELLS]
    jobs += [("serve_cell", arch, shape, dev) for arch, shape in DRYRUN_SERVE_CELLS
             for dev in ("cuda", "cpu")]
    jobs += [("lm_train", name) for name in LM_TRAIN_MODELS]
    jobs += [("serve", DRYRUN_SERVE_CALIBRATION)]
    with concurrent.futures.ProcessPoolExecutor(len(jobs),
                                                mp_context=mp.get_context("spawn")) as pool:
        done = dict(zip(jobs, pool.map(_dryrun_job, jobs)))
    launched = {job[1:]: n for job, (_, n) in done.items() if n}
    calibration, bad = {}, []
    for name, (over, batch, seq) in LM_TRAIN_MODELS.items():
        cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
        got = done[("lm_train", name)][0]
        run = measured[name]
        predicted = got["peak_bytes"] + run["held_beside_steps_bytes"]
        c = dict(traced=got["traced"], trace_s=got["seconds"], launches=got["launches"],
                 expected=lm_train_launches(cfg), step_peak_bytes=got["peak_bytes"],
                 peak_by_kind=got["peak_by_kind"], held_bytes=run["held_beside_steps_bytes"],
                 predicted_bytes=predicted, measured_bytes=run["steps_peak_memory_bytes"],
                 ratio=predicted / run["steps_peak_memory_bytes"],
                 dot_flops=got["hlo"]["dot_flops"], nvidia_smi=smi)
        calibration[name] = c
        print(f"dryrun calibration {name} ({smi}): predicted {predicted / 2**30:.3f} GiB "
              f"(step {got['peak_bytes'] / 2**30:.3f} + held {c['held_bytes'] / 2**30:.3f}) "
              f"against measured {c['measured_bytes'] / 2**30:.3f} GiB: ratio "
              f"{c['ratio']:.4f}; launches {c['launches']} (closed form {c['expected']}); "
              f"traced {c['traced']} in {c['trace_s']:.1f} s")
        if c["launches"] != c["expected"]:
            bad.append(f"{name}: launches {c['launches']}, closed form {c['expected']}")
        if abs(c["ratio"] - 1) > DRYRUN_PEAK_TOL:
            bad.append(f"{name}: predicted peak {predicted} against {c['measured_bytes']}")
    cells = {}
    for arch, multi in DRYRUN_CELLS:
        rec = done[("cell", arch, multi)][0]
        print(json.dumps({"dryrun_cell": rec}))
        cells[f"{arch}_{rec['mesh']}"] = rec
        if rec["status"] != "ran" or not (rec["hlo"]["dot_flops"] > 0
                                          and rec["hlo"]["coll_bytes"] > 0):
            bad.append(f"{arch} {rec['mesh']}: {rec['status']} {rec.get('reason')}")
    for arch, shape in DRYRUN_SERVE_CELLS:
        rec, cpu = (done[("serve_cell", arch, shape, d)][0] for d in ("cuda", "cpu"))
        print(json.dumps({"dryrun_cell": rec}))
        cells[f"{arch}_{shape}_{rec['mesh']}"] = rec
        same = ({k: v for k, v in rec.items() if k != "lower_s"}
                == {k: v for k, v in cpu.items() if k != "lower_s"})
        print(f"dryrun {arch} {shape} {rec['mesh']}: {rec['status']}, rows {rec.get('rows')}, "
              f"cache {rec.get('cache_bytes')} B (JAX's layout {rec.get('cache_bytes_jax_layout')}"
              f"), peak {rec.get('peak_bytes')} B, fits {rec.get('fits')}; record equal to the "
              f"CPU's but for lower_s: {same}")
        if rec["status"] != "ran" or not same or not rec["hlo"]["dot_flops"] > 0:
            bad.append(f"{arch} {shape}: {rec['status']}, equal to the CPU's record {same}")
    name = DRYRUN_SERVE_CALIBRATION
    got = done[("serve", name)][0]
    over, prompt_len = SERVE_MODELS[name]
    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
    measured_serve = results["serve"]["models"][name]["peak_memory_bytes"]
    c = dict(traced=got["traced"], trace_s=got["seconds"], launches=got["launches"],
             expected=serve_launches(cfg), predicted_bytes=got["peak_bytes"],
             peak_by_kind=got["peak_by_kind"], measured_bytes=measured_serve,
             ratio=got["peak_bytes"] / measured_serve, nvidia_smi=smi)
    calibration[f"{name} serve decode"] = c
    print(f"dryrun calibration {name} serve decode ({smi}): predicted "
          f"{c['predicted_bytes'] / 2**30:.3f} GiB against the serve phase's measured "
          f"{measured_serve / 2**30:.3f} GiB: ratio {c['ratio']:.4f}; launches {c['launches']} "
          f"(closed form {c['expected']})")
    if c["launches"] != c["expected"]:
        bad.append(f"{name} serve decode: launches {c['launches']}, closed form {c['expected']}")
    if abs(c["ratio"] - 1) > DRYRUN_PEAK_TOL:
        bad.append(f"{name} serve decode: predicted peak {c['predicted_bytes']} against "
                   f"{measured_serve}")
    if launched:
        bad.append(f"the dry run launched kernels: {launched}")
    card_memory = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun fits against the modelled card's {HBM_BYTES} B "
          f"({modelled_card()}); this card ({smi}) has {card_memory} B")
    real = dryrun_blind_spot()
    print(f"dryrun real step ({smi}): {json.dumps(real)}")
    if abs(real["ratio"] - 1) > DRYRUN_REAL_TOL:
        bad.append(f"the counter's peak of a real step is off the allocator's: {real}")
    results["dryrun"] = dict(calibration=calibration, cells=cells, real_step=real,
                             card_memory_bytes=card_memory, modelled_memory_bytes=HBM_BYTES,
                             launched={str(k): n for k, n in launched.items()})
    if bad:
        raise AssertionError("; ".join(bad))


# one spec of each kind re-tuned with --force: K3 at the stage-1 weight
# gradient, K1 at the stage-1 forward operand, K4 at the stage-1 conv
TUNE_FORCE = ("gemm:144x131072x16:e2m4:nc", "quantize:131072x256:e2m4:nc",
              "conv:128x16x32x32x16x3x3x1x1x1x1x1x1x144:e2m4:nc")
RESNET_PAIRS = 6  # ResNet-20 steps with the seed and with an empty cache, in turns


def resnet_step_with(cache, qcfg) -> dict:
    """One full-width ResNet-20 main-path step (batch 128, weights and data
    from seed 0, rounding key of step 0) resolving through ``cache``: loss,
    gradients, launches and the step's ms (host clock after a sync).
    cuDNN runs its deterministic algorithms (the fp32 stem conv's default
    weight gradient does not repeat itself), as the sweep's runner does."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import fold_in
    from repro_torch.kernels import autotune, launch_counts
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train.loop import init_state

    from repro_torch.sweep.runner import _deterministic_cudnn

    state = init_state(CNNConfig("resnet20", 10, 1.0, HW), BATCH, seed=0, device="cuda")
    b = next(state.data)
    with autotune.override_cache(cache), _deterministic_cudnn():
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = F.cross_entropy(state.model(b["image"], qcfg, fold_in(7, 0)), b["label"])
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in launch_counts().items()}
    names, params = zip(*state.model.named_parameters())
    return dict(loss=loss.detach(), grads=[p.grad.clone() for p in params], names=names,
                launches=launched, ms=ms)


def step_differences(u: dict, v: dict) -> list[str]:
    """The tensors in which two of resnet_step_with's steps differ (loss
    and each parameter's gradient, compared bit for bit): name, how many
    elements differ and the largest difference."""
    import torch

    out = []
    for name, x, y in zip(("loss",) + u["names"], [u["loss"]] + u["grads"],
                          [v["loss"]] + v["grads"]):
        if not torch.equal(x, y):
            out.append(f"{name}: {int((x != y).sum())} of {x.numel()} differ, max |d| "
                       f"{float((x - y).abs().max()):.6g}")
    return out


def phase_tune(results: dict) -> None:
    """The tile cache on the card: the committed seed's --check (static
    proofs with the built library's constants); every cached winner's
    output bit-identical to its default's and to the plain version at its
    spec's shape; --tune --force of TUNE_FORCE into chiprun_out/; the
    kernel bench into chiprun_out/; a full-width ResNet-20 main-path step
    with the seed cache and with an empty cache, equal bit for bit with
    the closed form's launches (120 K1 / 60 K3)."""
    import torch

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.kernels import autotune as at

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    seed = at.TuneCache.load(at.SEED_CACHE_PATH)
    here = at.device_name("cuda")
    t = time.perf_counter()
    check = at.check_cache(seed, at.specs_named("all"), device="cuda")
    r = dict(seed_device=seed.device, device=here, seed_applies=seed.device == here,
             check=dict(ok=check["ok"], verified=check["verified"],
                        failures=check["failures"][:5], s=time.perf_counter() - t))
    print(f"tune: seed cache of {seed.device} ({len(seed)} entries) checked on {here}: "
          f"{'OK' if check['ok'] else check['failures'][:3]} ({r['check']['s']:.1f} s)")

    t = time.perf_counter()
    winners = []
    for key, ent in sorted(seed.entries.items()):
        spec, config = at.TuneSpec.from_json(ent), at.BlockConfig.from_json(ent["config"])
        default = at.default_block_config(spec)
        outs = [at.config_call(spec, c, device="cuda")() for c in (config, default, None)]
        torch.cuda.synchronize()
        tup = [o if isinstance(o, tuple) else (o,) for o in outs]
        same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*tup))
        winners.append(dict(key=key, winner=config.to_json(), default=default.to_json(),
                            tuned_is_default=config == default, identical=same,
                            ms=ent["ms"]))
        del outs, tup
    torch.cuda.empty_cache()
    r["winners"] = winners
    r["winners_s"] = time.perf_counter() - t
    n_diff = sum(not w["tuned_is_default"] for w in winners)
    print(f"tune: {len(winners)} cached winners ({n_diff} not the default) against their "
          f"defaults and the plain versions: {sum(w['identical'] for w in winners)} identical "
          f"({r['winners_s']:.1f} s)")

    t = time.perf_counter()
    forced = at.TuneCache(device=here)
    specs = {s.key(): s for s in at.specs_named("all")}
    at.tune_all(forced, [specs[k] for k in TUNE_FORCE], force=True, device="cuda")
    forced.save(out_dir / "kernel_tune_forced.json")
    r["forced"] = {k: {f: forced.entries[k][f] for f in ("config", "ms", "candidates_timed",
                                                        "candidates_pruned")}
                   for k in TUNE_FORCE}
    r["forced_s"] = time.perf_counter() - t
    print(f"tune --force: {json.dumps(r['forced'])} ({r['forced_s']:.1f} s)")

    t = time.perf_counter()
    bench_json = out_dir / "BENCH_torch_kernels.json"
    proc = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "torch_kernel_bench.py"),
                           "--json", str(bench_json)], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    r["bench_s"] = time.perf_counter() - t
    if proc.returncode:
        raise AssertionError(f"torch_kernel_bench.py failed:\n{proc.stderr[-3000:]}")
    bench = json.loads(bench_json.read_text())
    r["bench_rows"] = len(bench["rows"])
    for row in bench["rows"]:
        print(json.dumps({"bench": {k: row[k] for k in ("kernel", "shape", "default", "tuned",
                                                        "kernel_ms", "bound_ms", "bound_by")},
                          "nvidia_smi": bench.get("nvidia_smi")}))

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    empty = at.TuneCache(device=here)
    steps = [resnet_step_with(cache, qcfg)  # in turns; the first pair is cold
             for _ in range(RESNET_PAIRS) for cache in (at.get_cache(), empty)]

    # each step against the first with its cache (even: seed, odd: empty), and the two firsts
    differing = {f"step {i} vs step {i % 2}": d for i in range(2, len(steps))
                 if (d := step_differences(steps[i % 2], steps[i]))}
    repeats = not differing
    between = step_differences(steps[0], steps[1])
    same = not between
    if between:
        differing["step 1 (empty cache) vs step 0 (seed cache)"] = between
    a, b = steps[0], steps[1]
    seed_ms, empty_ms = [u["ms"] for u in steps[::2]], [u["ms"] for u in steps[1::2]]
    want = {"mls_quantize_rows": 120, "mls_matmul": 60}
    r["resnet_step"] = dict(identical=same, repeats=repeats, loss=float(a["loss"]),
                            seed_ms=seed_ms, empty_ms=empty_ms,
                            seed_launches=a["launches"], empty_launches=b["launches"],
                            losses=[float(u["loss"]) for u in steps], differing=differing)
    print(f"tune: ResNet-20 step with the seed cache {statistics.median(seed_ms[1:]):.2f} ms, "
          f"with an empty cache {statistics.median(empty_ms[1:]):.2f} ms (medians of "
          f"{RESNET_PAIRS - 1} warm steps in turns; all {seed_ms} / {empty_ms}); loss and "
          f"gradients identical: {same}, repeated: {repeats}; launches {a['launches']} / "
          f"{b['launches']}")
    results["tune"] = r
    bad = []
    if not check["ok"]:
        bad.append(f"the seed cache does not check: {check['failures'][:3]}")
    if not all(w["identical"] for w in winners):
        bad.append(f"cached winners differ: {[w['key'] for w in winners if not w['identical']]}")
    if not (same and repeats):
        bad.append(f"the ResNet-20 step with the seed and an empty cache: identical {same}, "
                   f"each repeated {repeats}; steps' losses {r['resnet_step']['losses']}; "
                   f"differing: {json.dumps(differing)}")
    for launched in (a["launches"], b["launches"]):
        if {k: launched[k] for k in want} != want:
            bad.append(f"ResNet-20 step launches {launched}, expected {want}")
    if bad:
        raise AssertionError("; ".join(bad))


SWEEP_REPEAT = ("resnet20/fp32/fake_quant", "resnet20/mls_e2m1/pallas")  # run twice


def sweep_cell(cell, convs) -> dict:
    """Train one chip-grid cell on the card, counts set to 0 just before
    and read just after; every step's launches must equal the dispatch's
    count over ResNet-20's 20 quantized convs ("pallas": K1/K3 for "nc",
    K2/K3 for "c" and "none") or none at all (fake_quant, fp32), and every
    loss must be finite.  Step time: host clock, each step ending in a read
    of its loss; median of steps 2-40."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sweep.runner import cell_qcfg, cell_row, train_cell

    zero = dict.fromkeys(launch_counts(), 0)
    want = expected_launches(cell_qcfg(cell), convs) if cell.backend == "pallas" else zero
    reset_launch_counts()
    t0 = time.perf_counter()
    traj = train_cell(cell, "cuda")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    row = cell_row(cell, traj, wall)
    r = dict(row=row, losses=traj.losses, accs=traj.accs, wall_s=wall,
             median_step_ms=statistics.median(traj.step_s[1:]) * 1e3,
             first_step_ms=traj.step_s[0] * 1e3, launches=counts, expected_per_step=want)
    print(f"sweep {row['cell_id']}: loss {row['final_loss']} acc {row['final_acc']} median "
          f"step {r['median_step_ms']:.2f} ms wall {wall:.1f} s launches {counts}")
    if not all(math.isfinite(v) for v in traj.losses):
        raise AssertionError(f"{row['cell_id']}: non-finite loss {traj.losses}")
    for i, per in enumerate(traj.launches):
        if per != want:
            raise AssertionError(f"{row['cell_id']} step {i}: launches {per}, expected {want}")
    return r


def phase_sweep(results: dict) -> dict[str, dict[str, int]]:
    """The frontier sweep's chip grid (``repro_torch.sweep.chip_grid``:
    ResNet-20 at full width, CIFAR 32x32, batch 128, lr 0.05, 40 steps;
    fp32, <2,4>, <2,1> and <0,4> on fake_quant, <2,4> and <2,1> on the
    kernels, <2,1> on the kernels with grouping "c" and "none"), each cell
    seeded by its own generators; the frontier table; the gate against
    the committed chip entries of the port's baseline, which must pass, and
    its two negative controls, which must fail; two cells run again, which
    must take the same steps (the runner's cuDNN is deterministic), and
    the fp32 cell twice with cuDNN's default algorithms (reported); then
    the Table II benchmark (quick).  Returns each kernel's launches per step by "pallas" cell."""
    import importlib.util
    from unittest import mock

    from repro_torch.sweep import apply_gate, chip_grid, frontier_table, load_baseline
    from repro_torch.sweep import runner as sweep_runner
    from repro_torch.sweep.gate import SABOTAGE_MODES, sabotage_baseline

    convs = conv_list("resnet20", HW, BATCH)
    cells = {c.cell_id(): c for c in chip_grid()}
    runs = {cid: sweep_cell(c, convs) for cid, c in cells.items()}
    nc = {"mls_quantize_rows": 120, "mls_quantize_rows_amax": 0, "mls_quantize_rows_codes": 0,
          "mls_quantize_given_sg": 0, "mls_matmul": 60, "implicit_conv": 0,
          "conv_tensor_scale": 0, "sabotage_overlap": 0}
    for cid in ("resnet20/mls_e2m4/pallas", "resnet20/mls_e2m1/pallas"):
        if runs[cid]["expected_per_step"] != nc:
            raise AssertionError(f"{cid} no longer takes 120 K1 and 60 K3 launches a step "
                                 f"on im2col alone: {runs[cid]['expected_per_step']}")
    rows = [r["row"] for r in runs.values()]
    results["sweep"] = sweep = dict(cells=runs)
    print(frontier_table(rows, title="Bit-width x architecture frontier (chip grid, "
                                     f"{results['nvidia_smi']})"))
    baseline = load_baseline()
    failures = apply_gate(rows, baseline, grid_name="chip")
    sabotaged = {mode: apply_gate(rows, sabotage_baseline(baseline, mode, "chip"), "chip")
                 for mode in SABOTAGE_MODES}
    repeat = {}
    for cid in SWEEP_REPEAT:
        again = sweep_cell(cells[cid], convs)
        repeat[cid] = dict(losses_equal=again["losses"] == runs[cid]["losses"],
                           max_loss_diff=max(abs(a - b) for a, b in
                                             zip(again["losses"], runs[cid]["losses"])))
    # the control: cuDNN's default algorithms, which the runner replaces
    with mock.patch.object(sweep_runner, "_deterministic_cudnn", contextlib.nullcontext):
        a, b = (sweep_cell(cells[SWEEP_REPEAT[0]], convs) for _ in range(2))
    repeat["cudnn_default"] = dict(losses_equal=a["losses"] == b["losses"],
                                   max_loss_diff=max(abs(x - y) for x, y in
                                                     zip(a["losses"], b["losses"])),
                                   median_step_ms=(a["median_step_ms"], b["median_step_ms"]))
    print(json.dumps({"sweep_repeat": repeat}))
    spec = importlib.util.spec_from_file_location(
        "torch_table2_accuracy", ROOT / "benchmarks" / "torch_table2_accuracy.py")
    table2 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(table2)
    t = time.perf_counter()
    t2_rows = table2.run(quick=True, device="cuda")
    t2_s = time.perf_counter() - t
    for r in t2_rows:
        print(f'{r["name"]},{r["us_per_call"]:.1f},"{r["derived"]}"')
    sweep.update(gate_failures=failures, sabotaged=sabotaged, repeat=repeat, table2=t2_rows,
                 table2_s=t2_s)
    print(json.dumps({"sweep_gate": failures or "pass",
                      "sabotaged": {m: len(f) for m, f in sabotaged.items()}}))
    if failures:
        raise AssertionError(f"sweep gate failed: {failures}")
    if not all(sabotaged.values()):
        raise AssertionError(f"a sabotaged baseline passed the gate: {sabotaged}")
    if not all(repeat[cid]["losses_equal"] for cid in SWEEP_REPEAT):
        raise AssertionError(f"a cell run again on the card took other steps: {repeat}")
    bad = [r["name"] for r in t2_rows
           if r["final_loss"] is None or not math.isfinite(r["final_loss"])]
    if bad:
        raise AssertionError(f"Table II variants with non-finite loss: {bad}")
    return {cid: r["expected_per_step"] for cid, r in runs.items()
            if cells[cid].backend == "pallas"}


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if hasattr(tree, "device") else []


def k5_checks() -> dict:
    """K5 on the card against its plain version on the same inputs, timed.
    Launches made here are comparisons: they do not count for the path."""
    import torch

    from repro_torch.analysis.kernel_verify import writers_per_block
    from repro_torch.kernels.ref import sabotage_overlap_ref, sabotage_overlap_tiles
    from repro_torch.kernels.sabotage import launch_spec, sabotage_overlap_matmul

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 16), generator=gen, device="cuda")
    w = torch.randn((16, 32), generator=gen, device="cuda")
    probe = torch.zeros((8, 32), dtype=torch.int32, device="cuda")
    got = sabotage_overlap_matmul(x, w, probe)
    tiles = sabotage_overlap_tiles(x, w)
    _, writes = sabotage_overlap_ref(x, w)
    torch.cuda.synchronize()
    writers = writers_per_block(launch_spec(8, 16, 32, "cuda"), "outputs[0]")[0].tolist()
    stores = [sorted(set(probe[:, 8 * c : 8 * c + 8].flatten().tolist())) for c in range(4)]
    nan_gaps, from_writer, err, last_writer = True, True, 0.0, 0
    for c in range(4):
        block = got[:, 8 * c : 8 * c + 8]
        if writers[c] == 0:
            nan_gaps &= bool(torch.isnan(block).all())
            continue
        first, last = tiles[(0, c)], tiles[(0, c + 1)]
        bits = block.view(torch.int32)
        is_last = bits == last.view(torch.int32)
        from_writer &= bool((is_last | (bits == first.view(torch.int32))).all())
        last_writer += int(is_last.sum())
        err = max(err, float(torch.minimum((block - first).abs(), (block - last).abs()).max()))
    ok = (writers == [2, 0, 2, 0] and stores == [[w_] for w_ in writers] and nan_gaps
          and from_writer and torch.equal(probe, writes))
    out = dict(writers_per_block=writers, probe_by_block_column=stores, nan_gaps=nan_gaps,
               each_element_from_a_writer=from_writer,
               elements_from_the_last_writer=last_writer, max_abs_err=err, identical=ok,
               ms=cuda_ms(lambda: sabotage_overlap_matmul(x, w)),
               kernel_ms=kernel_ms(lambda: sabotage_overlap_matmul(x, w),
                                   "sabotage_overlap_kernel"),
               plain_ms=cuda_ms(lambda: sabotage_overlap_ref(x, w)),
               bytes=4 * (x.numel() + w.numel() + got.numel()), ops=2 * 8 * 32 * 16)
    print(json.dumps({"k5": out}))
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: {out}")
    return out


def expected_device_kernels(k_block: int) -> list[str]:
    """The device kernels a full-width ResNet-20 step ("nc", <2,4>) records,
    from the dispatch of each conv (``resolve_conv_impl``) and the tile
    cache's choice for each of its K1 and K3 calls (``qd_gemm``'s
    resolutions, as ``autotune.path_specs`` lists them)."""
    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.kernels import autotune, resolve_conv_impl

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=k_block)
    names = set()

    def quantize(m, k):
        c = autotune.resolve_block_config("quantize", (m, k), FMT_IMAGENET, k_block=k_block,
                                          device="cuda")
        names.update(("quantize_amax", f"quantize_groups_{c.variant}"))

    for g in conv_list("resnet20", HW, BATCH):
        gemms = [(g.k0, g.m0, g.o), (g.m0, g.o, g.k0)]
        if resolve_conv_impl(g, qcfg, "cuda") == "implicit":
            names.update(("conv_amax", "implicit_conv"))
            quantize(g.o, g.k0)
        else:
            gemms.append((g.m0, g.k0, g.o))
        for m, k, n in gemms:
            kp = -(-k // k_block) * k_block
            quantize(m, kp)
            quantize(n, kp)
            c = autotune.resolve_block_config("gemm", (m, k, n), FMT_IMAGENET, k_block=k_block,
                                              device="cuda")
            names.update({"walk": ("mls_matmul_walk",),
                          "split": ("mls_matmul_terms", "mls_matmul_sum"),
                          "wgmma": ("mls_matmul_decode", "mls_matmul_wgmma")}[c.variant])
    return sorted(names)


# the sabotage modes of the audit phase: mode, graph, the failures it must name
AUDIT_SABOTAGE = (
    ("overlap_write", "none", ("overlap violation at outputs[0]", "gap violation at outputs[0]")),
    ("deep_k", "none", ("overflow violation",)),
    ("drop_halo", "none", ("oob violation at window_grid",)),
    ("fp32_gemm", "train", ("train:resnet20: quantized fraction",
                            "train:resnet20@kb144: quantized fraction")))


def _audit_job(args: list[str]) -> tuple[int, float, dict[str, int]]:
    """One ``repro_torch.analysis.audit`` run in a worker process (TF32 off,
    as main() sets it): its exit code, its seconds and the kernels it
    launched (the counts set to 0 just before it)."""
    from repro_torch.analysis import audit
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import resolve_device

    resolve_device("cuda")
    reset_launch_counts()
    t = time.perf_counter()
    rc = audit.main(args)
    return rc, time.perf_counter() - t, launch_counts()


def phase_audit(results: dict) -> tuple[dict, int]:
    """K5 checked; then, in worker processes side by side (each audit is
    host work around a few launches: _audit_job), the clean audit at full
    width, the serve graph's and the four sabotage modes (AUDIT_SABOTAGE).
    Returns K5's timing row and its launches in the overlap_write run."""
    import concurrent.futures

    import torch.multiprocessing as mp

    k5 = k5_checks()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "AUDIT_torch_report.json"
    jobs = {"clean": ["--graph", "train", "--kernels", "--gate", "--out", str(path)],
            "serve": ["--graph", "serve", "--kernels", "--gate", "--out",
                      str(out_dir / "AUDIT_torch_serve.json")]}
    for mode, graph, _ in AUDIT_SABOTAGE:
        jobs[mode] = ["--graph", graph, "--gate", "--sabotage", mode, "--out",
                      str(out_dir / f"AUDIT_torch_{mode}.json")] + (
                          ["--kernels"] if graph == "none" else [])
    with concurrent.futures.ProcessPoolExecutor(len(jobs),
                                                mp_context=mp.get_context("spawn")) as pool:
        done = dict(zip(jobs, pool.map(_audit_job, jobs.values())))
    rc, seconds, _ = done["clean"]
    report = json.loads(path.read_text())
    graphs = report["graphs"]
    recorded = {name: report["kernels"]["kernels"][name] for name in graphs}
    # the fp32 MACs of a full-width step: the stem conv (forward, weight
    # gradient) and the classifier (forward, two gradients); a classifier
    # that missed the backward, which runs on autograd's device thread,
    # would count fewer
    fp = 2 * BATCH * 16 * HW * HW * 3 * 9 + 3 * BATCH * 64 * 10
    summary = dict(rc=rc, seconds=seconds, gate_pass=report["gate"]["pass"],
                   quantized_fraction={n: g["coverage"]["quantized_fraction"]
                                       for n, g in graphs.items()},
                   full_precision_macs={n: g["coverage"]["full_precision_macs"]
                                        for n, g in graphs.items()},
                   launches_per_step={n: g["launches"] for n, g in graphs.items()},
                   distinct_specs=report["kernels"]["distinct_launch_specs"],
                   recorded_specs={n: r["num_launch_specs"] for n, r in recorded.items()},
                   recorded_kernels={n: sorted({c["kernel"].split(" ")[1].split("[")[0]
                                                for c in r["calls"]})
                                     for n, r in recorded.items()})
    print(json.dumps({"audit": summary}))
    bad = []
    if rc != 0 or not report["gate"]["pass"]:
        bad.append(f"clean audit failed: {report['gate']['failures']}")
    if set(graphs) != {"train:resnet20", "train:resnet20@kb144"}:
        bad.append(f"graphs {sorted(graphs)}")
    if any(f < 0.99 for f in summary["quantized_fraction"].values()):
        bad.append(f"quantized fraction {summary['quantized_fraction']}")
    if any(v != fp for v in summary["full_precision_macs"].values()):
        bad.append(f"fp32 MACs {summary['full_precision_macs']}, expected {fp}")
    want = {"train:resnet20": expected_device_kernels(K_BLOCK),
            "train:resnet20@kb144": expected_device_kernels(K_BLOCK_IMPLICIT)}
    if summary["recorded_kernels"] != want:
        bad.append(f"recorded kernels {summary['recorded_kernels']}")
    # exactly the closed form of tests/test_torch_analysis.py: K3's MACs are
    # counted once per call, whatever its plan launches
    if summary["quantized_fraction"] != {"train:resnet20": 0.996968,
                                         "train:resnet20@kb144": 0.997035}:
        bad.append(f"quantized fraction {summary['quantized_fraction']} is not the closed form")
    # the stage-1 weight gradient's term phase: a parallel grid over the card
    stage1 = [c for c in recorded["train:resnet20"]["calls"]
              if "mls_matmul_terms[" in c["kernel"]
              and c["grid"] == [["tile_m", 3], ["tile_n", 1], ["group", BATCH * HW * HW // K_BLOCK]]]
    summary["stage1_wgrad_term_programs"] = [math.prod(n for _, n in c["grid"]) for c in stage1]
    if not stage1 or not all(c["ok"] and math.prod(n for _, n in c["grid"]) >= 132
                             for c in stage1):
        bad.append(f"stage-1 weight gradient term phase not recorded as a proven grid of >= 132 "
                   f"programs: {stage1}")
    # the serve graph: one quantized decode step of qwen2-72b's smoke config
    # (batch 4, cache 128); its fraction is the closed form of
    # tests/test_torch_analysis.py
    rc = done["serve"][0]
    serve = json.loads((out_dir / "AUDIT_torch_serve.json").read_text())
    entry = serve["graphs"]["serve:qwen2-72b"]
    summary["serve_graph"] = dict(rc=rc, gate_pass=serve["gate"]["pass"],
                                  quantized_fraction=entry["coverage"]["quantized_fraction"],
                                  launches=entry["launches"],
                                  kernels_ok=serve["kernels"]["kernels"]["serve:qwen2-72b"]["ok"])
    print(json.dumps({"audit_serve": summary["serve_graph"]}))
    if (rc != 0 or not serve["gate"]["pass"] or not summary["serve_graph"]["kernels_ok"]
            or summary["serve_graph"]["quantized_fraction"] != 0.619048
            or entry["launches"] != 42):
        bad.append(f"serve audit: {summary['serve_graph']}, {serve['gate']['failures']}")
    sabotage = {}
    k5_launches = done["overlap_write"][2]["sabotage_overlap"]  # K5's launches in that run
    for mode, _, named in AUDIT_SABOTAGE:
        rc = done[mode][0]
        failures = json.loads((out_dir / f"AUDIT_torch_{mode}.json").read_text())["gate"][
            "failures"]
        named_ok = all(any(n in f for f in failures) for n in named)
        sabotage[mode] = dict(rc=rc, named=named_ok, failures=failures[:4])
        if rc != 1 or not named_ok:
            bad.append(f"sabotage {mode}: rc {rc}, failures {failures}")
    summary["sabotage"] = sabotage
    summary["k5_launches_under_overlap_write"] = k5_launches
    results["audit"] = summary
    results["k5"] = k5
    print(json.dumps({"sabotage": sabotage}))
    if k5_launches != 1:
        bad.append(f"overlap_write launched K5 {k5_launches} times, expected 1")
    if bad:
        raise AssertionError("; ".join(bad))
    bound_bytes = k5["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops = k5["ops"] / FP32_OPS_PER_S * 1e3
    row = dict(name="sabotage_overlap", shape="x (8, 16) @ w (16, 32)", ms=k5["ms"],
               plain_ms=k5["plain_ms"], bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations",
               max_abs_err=k5["max_abs_err"], kernel_ms=k5["kernel_ms"])
    return row, k5_launches


# chatglm3-6b's MLP up-projection weight gradient (d_model x d_ff)
COMPRESS_SHAPE = (4096, 13696)
RING_NUMEL = (1 << 20) + 77  # the two-process ring's gradient: a ragged tail
RING_SEED = 11


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ring_grad(rank: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(RING_SEED * 100 + rank)
    return torch.randn(RING_NUMEL, generator=gen, device="cuda") * (1e-3 * (rank + 1))


def _ring_rank(rank: int, world: int, port: int, out: str) -> None:
    """One rank of the compressed ring on cuda:0 over gloo."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import compress

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        g = _ring_grad(rank)
        reset_launch_counts()
        compress.reset_wire_counts()
        res = compress.crosspod_allreduce_mean(g)
        torch.cuda.synchronize()
        torch.save({"out": res.cpu(), "wire": dict(compress.WIRE),
                    "k1": launch_counts()["mls_quantize_rows"]}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def ring_on_one_card() -> dict:
    """The ring in two processes on cuda:0 (gloo: NCCL takes one card a
    rank), against the ordered sum of each rank's decoded payload here."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.parallel import compress

    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "ring")
        mp.spawn(_ring_rank, args=(world, _free_port(), out), nprocs=world, join=True)
        ranks = [torch.load(f"{out}.{r}") for r in range(world)]
    grads = [_ring_grad(r) for r in range(world)]
    payloads = [compress.compress(g) for g in grads]
    rows = -(-RING_NUMEL // 128)
    ideal = {"u8": rows * 128 * (world - 1), "f32": (rows * 4 + 4) * (world - 1),
             "sends": 3 * (world - 1)}
    same, wire_ok = [], []
    for i, r in enumerate(ranks):
        acc = grads[i].float()
        for h in range(1, world):
            acc = acc + compress.decompress(*payloads[(i - h) % world], grads[i].shape)
        same.append(torch.equal(r["out"], (acc / world).cpu()))
        wire_ok.append(r["wire"] == ideal)
    return dict(numel=RING_NUMEL, world=world, bit_identical=same, wire=ranks[0]["wire"],
                ideal_wire=ideal, wire_exact=wire_ok, k1_launches=[r["k1"] for r in ranks])


# the wire path: the launcher's FSDP wire formats in a world of two on cuda:0
WIRE_ARCH = "mamba2-370m"
WIRE_LAYERS = 12  # of 48: the whole depth took 104 s, where the path has 60
WIRE_ROWS, WIRE_SEQ = 2, 1024  # a rank's rows x tokens
WIRE_TOL = 1e-6  # the CPU test's (tests/test_torch_wire.py): losses and parameters
WIRE_KEY = 7


def _host_full(t):
    """A parameter or gradient of the launcher's HSDP layout whole, on the
    host: a DTensor's shards gathered with c10d's all-gather (DTensor's
    ``full_tensor`` takes the functional collectives, whose gloo path on
    CUDA tensors crashes in torch 2.11)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t.detach().cpu()
    local = t.to_local().detach()
    for mesh_dim, place in enumerate(t.placements):
        if place.is_shard():
            group = t.device_mesh.get_group(mesh_dim)
            n = dist.get_world_size(group)
            src = local.movedim(place.dim, 0).contiguous()
            out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=group)
            local = out.movedim(0, place.dim)
    if tuple(local.shape) != tuple(t.shape):
        raise ValueError(f"uneven shards of {tuple(t.shape)}: gathered {tuple(local.shape)}")
    return local.cpu()


def _wire_run(cfg, mesh, batches, counted: bool = False) -> dict:
    """The launcher's layout of ``cfg`` over ``mesh`` (shard_model): with
    ``counted``, first one loss and backward on this rank's slice of
    ``batches[0]`` under trace_counts.StepCounter (its all-gather and
    reduce-scatter bytes by payload dtype, the full gradients on the host);
    then two train steps from the same start: the losses and the full
    parameters (host)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.launch import train as launcher
    from repro_torch.launch.trace_counts import StepCounter, mesh_dims
    from repro_torch.models.lm import init_lm
    from repro_torch.train import make_train_step

    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=batches[0]["tokens"].shape[0],
                                seq_len=WIRE_SEQ)
    step_fn, opt_init = make_train_step(RunConfig(model=cfg, shape=shape))
    model = launcher.shard_model(init_lm(cfg, seed=0, device="cuda"), mesh)
    r: dict = {}
    if counted:
        counter = StepCounter(mesh_dims(mesh))
        with counter:
            loss, _ = model.loss(launcher.local_batch(batches[0], mesh), WIRE_KEY)
            loss.backward()
        r["wire"] = counter.hlo()["coll_breakdown"]
        r["loss"] = loss.item()
        r["grads"] = {k: _host_full(p.grad) for k, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
    opt = opt_init(model)
    losses = []
    for b in batches:
        model, opt, m = step_fn(model, opt, launcher.local_batch(b, mesh))
        loss = m["loss"].detach().clone()  # the global batch's: the mean of the ranks'
        dist.all_reduce(loss)
        losses.append(loss.item() / dist.get_world_size())
    r["losses"] = losses
    r["params"] = {k: _host_full(p) for k, p in model.named_parameters()}
    del model, opt
    torch.cuda.empty_cache()
    return r


def _wire_rank(rank: int, world: int, port: int, out: str) -> None:
    """One rank of the wire path (:func:`wire_on_one_card`) on cuda:0 over gloo."""
    import dataclasses
    import faulthandler

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, RunConfig, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as launcher
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime import resolve_device
    from repro_torch.train import make_train_step

    faulthandler.enable()
    resolve_device("cuda")  # TF32 off
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        base = dataclasses.replace(get_config(WIRE_ARCH), n_layers=WIRE_LAYERS)
        mesh = launcher.hsdp_mesh(world, device_type="cuda")
        data = lm_train_data(base, WIRE_ROWS * world, WIRE_SEQ)
        batches = [next(data) for _ in range(2)]
        res: dict = {"coord": tuple(mesh.get_coordinate())}
        # the 2-byte gather on K1/K3 (the path's launches: set to 0 just before)
        bf16 = dataclasses.replace(base, quant_backend="pallas", param_gather_dtype="bfloat16")
        reset_launch_counts()
        t = time.perf_counter()
        run = _wire_run(bf16, mesh, batches)
        torch.cuda.synchronize()
        res["bf16_s"] = time.perf_counter() - t
        res["launches"] = launch_counts()
        # the 1-byte gather (fake-quant) against the same mesh's unpacked step
        fq = dataclasses.replace(base, quant_backend="fake_quant")
        t = time.perf_counter()
        packed = _wire_run(dataclasses.replace(fq, packed_wire=True), mesh, batches, True)
        plain = _wire_run(fq, mesh, batches, True)
        res["packed_s"] = time.perf_counter() - t
        res["wire"], res["wire_plain"] = packed["wire"], plain["wire"]
        res["packed_equal"] = {
            "loss": packed["loss"] == plain["loss"] and packed["losses"] == plain["losses"],
            "grads": [k for k in plain["grads"]
                      if not torch.equal(packed["grads"][k], plain["grads"][k])],
            "params": [k for k in plain["params"]
                       if not torch.equal(packed["params"][k], plain["params"][k])]}
        del packed, plain
        if rank == 0:  # one process: the ranks' slices as two microbatches
            shape = dataclasses.replace(SHAPES["train_4k"], global_batch=WIRE_ROWS * world,
                                        seq_len=WIRE_SEQ)
            step_fn, opt_init = make_train_step(RunConfig(model=bf16, shape=shape,
                                                          microbatch=world))
            model = init_lm(bf16, seed=0, device="cuda")
            opt, losses = opt_init(model), []
            for b in batches:
                model, opt, m = step_fn(model, opt, b)
                losses.append(m["loss"].item())
            res["bf16_losses"], res["one_process_losses"] = run["losses"], losses
            res["bf16_param_err"] = max((run["params"][k] - p.detach().cpu()).abs().max().item()
                                        for k, p in model.named_parameters())
            del model, opt
        torch.cuda.empty_cache()
        res["placement"] = _placement_run(world)
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def wire_on_one_card(smi: str) -> dict:
    """mamba2-370m at full width (WIRE_LAYERS of its 48 layers) under the
    launcher's FSDP wire formats, in two processes on cuda:0 over gloo (2 x
    1024 a rank, 2 steps): the 2-byte
    gather on K1/K3 against one process taking the ranks' slices as two
    microbatches (WIRE_TOL, the CPU test's), the 1-byte gather (fake-quant)
    against the same mesh's unpacked step bit for bit (loss, gradients,
    parameters), and one step's all-gather bytes against the closed form;
    then the placement path in the same ranks (:func:`_placement_run`)."""
    import dataclasses
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import abstract_params
    from repro_torch.parallel.fsdp_wire import wire_bytes, wire_plan

    world = 2
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "wire")
        mp.spawn(_wire_rank, args=(world, _free_port(), out), nprocs=world, join=True)
        ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    base = dataclasses.replace(get_config(WIRE_ARCH), n_layers=WIRE_LAYERS)
    cfg = dataclasses.replace(base, quant_backend="fake_quant", packed_wire=True)
    shapes = {k: tuple(v.shape) for k, v in abstract_params(cfg).items()}
    pinned = wire_plan(cfg, shapes, world)[0]
    closed = wire_bytes(cfg, shapes, world)
    uses = 2 if cfg.remat == "full" else 1  # the forward, and remat's recompute
    master = sum(4 * shapes[k][0] * shapes[k][1] for k in pinned) * (world - 1) / world
    # the masters' two FSDP2 gathers (forward, backward) leave; the scales come
    want_u8, saved = uses * closed["codes"], 2 * master - uses * closed["scales"]
    bf16 = dataclasses.replace(base, quant_backend="pallas", param_gather_dtype="bfloat16")
    per_step = lm_train_launches(bf16)
    r0 = ranks[0]
    out = dict(arch=WIRE_ARCH, n_layers=WIRE_LAYERS, world=world, rows_per_rank=WIRE_ROWS,
               seq=WIRE_SEQ,
               nvidia_smi=smi, seconds=time.perf_counter() - t,
               bf16_losses=r0["bf16_losses"], one_process_losses=r0["one_process_losses"],
               bf16_param_err=r0["bf16_param_err"],
               launches=[{k: r["launches"].get(k, 0) for k in per_step} for r in ranks],
               expected_launches={k: 2 * n for k, n in per_step.items()},
               packed_equal=[r["packed_equal"] for r in ranks],
               all_gather_u8=[r["wire"].get("all-gather:u8", 0.0) for r in ranks],
               all_gather_f32_saved=[r["wire_plain"]["all-gather:f32"]
                                     - r["wire"]["all-gather:f32"] for r in ranks],
               want_u8=want_u8, want_f32_saved=saved,
               reduce_scatter=[(r["wire"]["reduce-scatter"], r["wire_plain"]["reduce-scatter"])
                               for r in ranks],
               pinned=len(pinned), rank_s=[(r["bf16_s"], r["packed_s"]) for r in ranks],
               placement=placement_summary([r["placement"] for r in ranks], smi))
    return out


def wire_failures(w: dict) -> list[str]:
    """What the wire path's checks found wrong (empty: all held)."""
    bad = []
    if not (max(abs(a - b) for a, b in zip(w["bf16_losses"], w["one_process_losses"]))
            <= WIRE_TOL and w["bf16_param_err"] <= WIRE_TOL):
        bad.append(f"the 2-byte gather's steps differ from one process: {w}")
    if any(n != w["expected_launches"] for n in w["launches"]):
        bad.append(f"wire path launches {w['launches']}, expected {w['expected_launches']}")
    if not all(e["loss"] and not e["grads"] and not e["params"] for e in w["packed_equal"]):
        bad.append(f"the 1-byte gather differs from the unpacked step: {w['packed_equal']}")
    if not (all(b == w["want_u8"] for b in w["all_gather_u8"])
            and all(b == w["want_f32_saved"] for b in w["all_gather_f32_saved"])
            and all(a == b for a, b in w["reduce_scatter"]) and w["want_u8"] > 0):
        bad.append(f"the step's all-gather bytes are not the closed form: {w}")
    return bad


# the placement path: a rank's stack of fewer experts than data ranks
PLACE_ARCH = "moonshot-v1-16b-a3b"
PLACE_CUTS = dict(n_layers=2, n_experts=1, top_k=1)  # of 48 layers, 64 experts, top 6
PLACE_ROWS, PLACE_SEQ = 1, 512  # a rank's rows x tokens
PLACE_STACKS = {"moe.w_gate": 1, "moe.w_up": 1, "moe.w_down": 2}  # JAX's fsdp dim


def _local_part(full, placements, mesh):
    """This rank's shard of ``full`` under a DTensor's ``placements`` on
    ``mesh`` (torch.chunk's split, as FSDP2's)."""
    for i, pl in enumerate(placements):
        if pl.is_shard():
            full = full.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return full


def _placement_run(world: int) -> dict:
    """The placement path in a rank of the wire path's world
    (:func:`_wire_rank`): the expert stacks' placements and local bytes,
    then one step on this rank's slice; its loss, its first AdamW moment
    ((1 - b1) x the clipped gradient) and its parameters, each shard held
    to the same shard of one process taking the ranks' slices as two
    microbatches (run in every rank, so that no shard leaves the card)."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPES, RunConfig, get_config
    from repro_torch.core import fold_in
    from repro_torch.launch import train as launcher
    from repro_torch.models.lm import init_lm
    from repro_torch.train import make_train_step

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(PLACE_ARCH), **PLACE_CUTS)
    mesh = launcher.hsdp_mesh(world, device_type="cuda")
    batch = next(lm_train_data(cfg, PLACE_ROWS * world, PLACE_SEQ))
    run = RunConfig(model=cfg, shape=dataclasses.replace(
        SHAPES["train_4k"], global_batch=PLACE_ROWS * world, seq_len=PLACE_SEQ))
    torch.cuda.reset_peak_memory_stats()
    model = launcher.shard_model(init_lm(cfg, seed=0, device="cuda"), mesh)
    layout = {k: (p.placements, p.device_mesh) for k, p in model.named_parameters()}
    res: dict = {"stacks": {
        k: (tuple(p.placements), tuple(p.shape), p.to_local().numel() * p.element_size())
        for k, p in model.named_parameters() if k.split(".", 2)[-1] in PLACE_STACKS}}
    step_fn, opt_init = make_train_step(run)
    model, opt, m = step_fn(model, opt_init(model), launcher.local_batch(batch, mesh))
    res["loss"] = m["loss"].item()
    mu = {k: v.clone() for k, v in opt.mu.items()}
    params = {k: p.to_local().detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del model, opt
    torch.cuda.empty_cache()
    ref = init_lm(cfg, seed=0, device="cuda")
    with torch.no_grad():  # each slice's loss under the step's key
        res["one_process_losses"] = [ref.loss({"tokens": part}, fold_in(run.seed, 0))[0].item()
                                     for part in batch["tokens"].chunk(world)]
    step_fn, opt_init = make_train_step(dataclasses.replace(run, microbatch=world))
    ref, opt, _ = step_fn(ref, opt_init(ref), batch)
    res["grad_err"] = max((mu[k] - _local_part(v, *layout[k])).abs().max().item()
                          for k, v in opt.mu.items())
    res["param_err"] = max((params[k] - _local_part(p.detach(), *layout[k])).abs().max().item()
                           for k, p in ref.named_parameters())
    del ref, opt, mu, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t
    return res


def placement_summary(ranks: list[dict], smi: str) -> dict:
    """The placement path's ranks (:func:`_placement_run`) summed up."""
    return dict(arch=PLACE_ARCH, world=len(ranks), rows_per_rank=PLACE_ROWS, seq=PLACE_SEQ,
                reduced={"n_layers": "2 of 48", "n_experts": "1 of 64 routed",
                         "top_k": "1 of 6", "tokens": f"{PLACE_ROWS} x {PLACE_SEQ} a rank",
                         "steps": 1},
                nvidia_smi=smi, seconds=max(r["seconds"] for r in ranks),
                stacks=[{k: (str(pl), shape, b) for k, (pl, shape, b) in r["stacks"].items()}
                        for r in ranks],
                placements_ok=[all(pl[-1].is_shard(PLACE_STACKS[k.split(".", 2)[-1]])
                                   for k, (pl, _, _) in r["stacks"].items())
                               for r in ranks],
                half_bytes=[all(2 * b == 4 * math.prod(shape)
                                for _, shape, b in r["stacks"].values()) for r in ranks],
                n_stacks=[len(r["stacks"]) for r in ranks],
                losses=[r["loss"] for r in ranks],
                one_process_losses=ranks[0]["one_process_losses"],
                grad_err=[r["grad_err"] for r in ranks],
                param_err=[r["param_err"] for r in ranks],
                max_memory_allocated=[r["max_memory_allocated"] for r in ranks])


def placement_failures(w: dict) -> list[str]:
    """What the placement path's checks found wrong (empty: all held)."""
    bad = []
    if not (all(w["placements_ok"]) and all(w["half_bytes"])
            and all(n == 3 * PLACE_CUTS["n_layers"] for n in w["n_stacks"])):
        bad.append(f"the expert stacks' placements or local bytes: {w['stacks']}")
    if not (max(abs(a - b) for a, b in zip(w["losses"], w["one_process_losses"])) <= WIRE_TOL
            and max(w["grad_err"] + w["param_err"]) <= WIRE_TOL):
        bad.append(f"the placement path's step differs from one process: {w}")
    return bad


def hsdp_world_one(smi: str) -> dict:
    """mamba2-370m at full width, 4 x 1024 on K1/K3: the launcher's HSDP
    wrapping on a world of one against the unwrapped step, bit for bit."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, RunConfig, get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as launcher
    from repro_torch.models.lm import init_lm
    from repro_torch.train import make_train_step

    name = "mamba2-370m"
    over, batch, seq = LM_TRAIN_MODELS[name]
    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
    step_fn, opt_init = make_train_step(RunConfig(model=cfg, shape=SHAPES["train_4k"]))
    want = lm_train_launches(cfg)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = launcher.hsdp_mesh(1, device_type="cuda")
        sharded = launcher.shard_model(init_lm(cfg, seed=0, device="cuda"), mesh)
        opt = opt_init(sharded)
        data = lm_train_data(cfg, batch, seq)
        inputs = [next(data) for _ in range(2)]
        steps, per_step, metrics = [], [], []
        for b in inputs:
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            sharded, opt, m = step_fn(sharded, opt, launcher.local_batch(b, mesh))
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t) * 1e3)
            per_step.append({k: launch_counts()[k] - before[k] for k in want})
            metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
        main_path = launch_counts()  # the comparison below launches too
        after = {k: p.full_tensor() for k, p in sharded.named_parameters()}
        del sharded, opt
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    plain = init_lm(cfg, seed=0, device="cuda")
    opt = opt_init(plain)
    same_metrics, plain_ms = [], []
    for b, (loss, gnorm) in zip(inputs, metrics):
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain, opt, m = step_fn(plain, opt, b)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t) * 1e3)
        same_metrics.append(torch.equal(loss, m["loss"]) and torch.equal(gnorm, m["grad_norm"]))
    same_params = all(torch.equal(after[k], p.detach()) for k, p in plain.named_parameters())
    r = dict(arch=name, batch=batch, seq=seq, losses=[float(l) for l, _ in metrics],
             grad_norms=[float(g) for _, g in metrics], metrics_bit_identical=same_metrics,
             params_bit_identical=same_params, hsdp_steps_ms=steps, plain_steps_ms=plain_ms,
             launches_per_step=per_step, expected_per_step=want, nvidia_smi=smi,
             main_path_counts=main_path)
    del plain, opt, after
    torch.cuda.empty_cache()
    return r


def emit_checks(gen) -> tuple[dict, dict]:
    """K4 with emit_codes at stage 1 "nc" against im2col -> K1, and its y
    against the default path; both timed, and the emit row's byte bound."""
    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import implicit_conv_forward, mls_quantize, rounding_bytes
    from repro_torch.kernels.implicit_conv import conv_geometry
    from repro_torch.kernels.ref import im2col, implicit_conv_ref

    xs, ws, stride, kb = CONV_SHAPES["stage1_conv"]
    geom = conv_geometry(xs, ws, stride, "SAME")
    x = torch.randn(xs, generator=gen, device="cuda")
    w = torch.randn(ws, generator=gen, device="cuda") * 0.1
    rx = rounding_bytes((geom.m0, geom.k0), gen, x.device)
    rw = rounding_bytes((geom.o, geom.k0), gen, x.device)
    kw = dict(fmt=FMT_IMAGENET, k_block=kb, grouping="nc")
    y, codes, x_sg, s_t = implicit_conv_forward(x, w, rx, rw, stride, "SAME", **kw,
                                                emit_codes=True)
    cols, _ = im2col(x, ws[2:], stride, geom.pads)
    want = mls_quantize(cols.contiguous(), FMT_IMAGENET, kb, GS_FMT_DEFAULT, rx, "nc")
    y0 = implicit_conv_forward(x, w, rx, rw, stride, "SAME", **kw)
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip((codes, x_sg, s_t), want))
            and torch.equal(y, y0))
    err = max(max_abs_err(a, b) for a, b in zip((codes, x_sg, s_t, y), (*want, y0)))
    emit = lambda: implicit_conv_forward(x, w, rx, rw, stride, "SAME", **kw,  # noqa: E731
                                         emit_codes=True)
    default = lambda: implicit_conv_forward(x, w, rx, rw, stride, "SAME", **kw)  # noqa: E731
    x_bytes = x.numel() * 4
    out_bytes = geom.m0 * geom.o * 4
    emit_bytes = geom.m0 * geom.k0 + geom.m0 * (geom.k0 // kb) * 4 + 4
    nbytes = (x_bytes + rx.numel() + rw.numel() + w.numel() * 4 + out_bytes + emit_bytes)
    ops = 2 * geom.m0 * geom.k0 * geom.o
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    row = dict(name="implicit_conv", shape=f"stage1_conv emit_codes nc {tuple(xs)}",
               ms=cuda_ms(emit), default_ms=cuda_ms(default),
               kernel_ms=kernel_ms(emit, DEVICE_KERNELS["implicit_conv"]),
               default_kernel_ms=kernel_ms(default, DEVICE_KERNELS["implicit_conv"]),
               plain_ms=cuda_ms(lambda: implicit_conv_ref(x, w, rx, rw, stride, geom.pads, **kw,
                                                          emit_codes=True), iters=5),
               bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations",
               max_abs_err=err)
    return dict(identical=same, max_abs_err=err), row


def compress_rows(gen) -> tuple[list[dict], list[dict]]:
    """compress of the w_up gradient on K1 against its plain version, at
    nearest and with rounding bytes, timed beside the byte bound."""
    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import rounding_bytes
    from repro_torch.kernels.ref import quantize_ref
    from repro_torch.parallel import compress

    g = torch.randn(COMPRESS_SHAPE, generator=gen, device="cuda") * 1e-3
    n = g.numel()
    rows_shape = (n // 128, 128)
    checks, rows = [], []
    for mode in ("nearest", "bytes"):
        r = rounding_bytes(rows_shape, gen, g.device) if mode == "bytes" else None
        got = compress.compress(g, r_u8=r)
        want = quantize_ref(g.reshape(rows_shape), FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        checks.append(dict(kernel="mls_quantize_rows", shape=f"compress {COMPRESS_SHAPE} {mode}",
                           identical=same, max_abs_err=err))
        fn = lambda: compress.compress(g, r_u8=r)  # noqa: E731
        nbytes = n * 4 + n + rows_shape[0] * 4 + 4 + (n if r is not None else 0)
        rows.append(dict(
            name="mls_quantize_rows", shape=f"compress w_up grad {COMPRESS_SHAPE} as "
            f"{rows_shape} nc {mode}", ms=cuda_ms(fn),
            kernel_ms=kernel_ms(fn, DEVICE_KERNELS["mls_quantize_rows"]),
            plain_ms=cuda_ms(lambda: quantize_ref(g.reshape(rows_shape), FMT_IMAGENET, 128,
                                                  GS_FMT_DEFAULT, r, "nc"), iters=5),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes,
            max_abs_err=err))
        del r, got, want
    del g
    torch.cuda.empty_cache()
    return checks, rows


def phase_parallel(results: dict) -> dict[str, int]:
    """The parallel slice (see the module docstring, phase 14)."""
    import torch

    from repro_torch.analysis.wire import audit_wire_ring
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import compress
    from repro_torch.sweep.record import nvidia_smi

    smi = nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(22)
    g = torch.randn(COMPRESS_SHAPE, generator=gen, device="cuda") * 1e-3
    torch.cuda.synchronize()
    reset_launch_counts()  # the main path: compress, then the HSDP steps
    payload = compress.compress(g)
    hsdp = hsdp_world_one(smi)  # reads the counts after its HSDP steps
    launched = hsdp.pop("main_path_counts")
    out = dict(main_path_launches=launched, hsdp=hsdp,
               compress_payload_bytes=sum(t.numel() * t.element_size() for t in payload))
    del g, payload
    checks, rows = compress_rows(gen)
    emit, emit_row = emit_checks(gen)
    checks.append(dict(kernel="implicit_conv", shape="stage1_conv emit_codes nc", **emit))
    rows.append(emit_row)
    out["ring"] = ring_on_one_card()
    out["wire"] = wire_on_one_card(smi)
    out["wire_audit"] = audit_wire_ring()
    out["checks"], out["rows"] = checks, rows
    results["parallel"] = out
    for row in rows:
        print(json.dumps({"timing": row}))
    print(f"parallel ({smi}): main-path launches {launched}; HSDP world-1 steps "
          f"{[round(t, 1) for t in hsdp['hsdp_steps_ms']]} ms vs unwrapped "
          f"{[round(t, 1) for t in hsdp['plain_steps_ms']]} ms, losses {hsdp['losses']}; ring "
          f"{out['ring']['bit_identical']} wire {out['ring']['wire']}; wire audit ratio "
          f"{out['wire_audit']['compression_ratio']:.4f}")
    wp = out["wire"]
    print(f"wire ({smi}): {wp['arch']} ({wp['n_layers']} layers) world {wp['world']} x "
          f"{wp['rows_per_rank']} x "
          f"{wp['seq']}; bf16 gather on K1/K3 losses {wp['bf16_losses']} vs one process "
          f"{wp['one_process_losses']} (params max err {wp['bf16_param_err']:.3g}), launches "
          f"{wp['launches']}; packed vs unpacked {wp['packed_equal']}; all-gather u8 "
          f"{wp['all_gather_u8']} B (closed form {wp['want_u8']}), f32 saved "
          f"{wp['all_gather_f32_saved']} B (closed form {wp['want_f32_saved']}); "
          f"{wp['seconds']:.1f} s")
    pp = wp["placement"]
    print(f"placement ({smi}): {pp['arch']} reduced {pp['reduced']}, world {pp['world']}: "
          f"stacks {pp['stacks'][0]}; losses {pp['losses']} vs one process "
          f"{pp['one_process_losses']}, first moments max err {pp['grad_err']}, params max err "
          f"{pp['param_err']}; max_memory_allocated per rank "
          f"{[round(b / 2 ** 30, 3) for b in pp['max_memory_allocated']]} GiB; "
          f"{pp['seconds']:.1f} s")
    bad = [c for c in checks if not c["identical"]]
    w = out["wire_audit"]
    if bad:
        bad = [f"{len(bad)} results differ from their plain versions: {bad}"]
    if not (all(hsdp["metrics_bit_identical"]) and hsdp["params_bit_identical"]):
        bad.append(f"the HSDP step differs from the unwrapped one: {hsdp}")
    if any(p != hsdp["expected_per_step"] for p in hsdp["launches_per_step"]):
        bad.append(f"HSDP launches {hsdp['launches_per_step']}, expected "
                   f"{hsdp['expected_per_step']}")
    bad += wire_failures(wp)
    bad += placement_failures(pp)
    if not (all(out["ring"]["bit_identical"]) and all(out["ring"]["wire_exact"])
            and all(n == 1 for n in out["ring"]["k1_launches"])):
        bad.append(f"the ring: {out['ring']}")
    if not (w["wire_bytes_per_device"] == w["ideal_compressed_bytes_per_device"]
            and w["compression_ratio"] >= 3.5):
        bad.append(f"wire audit {w}")
    if launched["mls_quantize_rows"] != 1 + 2 * hsdp["expected_per_step"]["mls_quantize_rows"]:
        bad.append(f"K1 launches on the main path {launched}")
    if bad:
        raise AssertionError("; ".join(bad))
    return launched


# ---------------------------------------------------------------------------
# phase 15: tensor parallelism over the model axis
# ---------------------------------------------------------------------------
TP_BATCH, TP_SEQ, TP_AXIS = 1, 4096, 2
# the paths (arch: layers, cut): chatglm3-6b (dense) and zamba2-7b (hybrid: one
# full segment of 6 Mamba2 layers, the shared block once, one tail layer)
TP_PATHS = {"chatglm3-6b": (2, "n_layers 28 -> 2; train_4k's global batch 256 -> 1 (seq 4096)"),
            "zamba2-7b": (7, "n_layers 81 -> 7 (one segment of 6, the shared block once, one "
                             "tail layer); train_4k's global batch 256 -> 1 (seq 4096)"),
            "moonshot-v1-16b-a3b": (2, "n_layers 48 -> 2 (both MoE layers: 64 experts, 32 a "
                                       "rank, top 6, capacity 385 at 4096 tokens); train_4k's "
                                       "global batch 256 -> 1 (seq 4096)"),
            "seamless-m4t-medium": (2, "12 + 12 layers -> 2 + 2 (the model-16 world's time); "
                                       "train_4k's global batch 256 -> 1 (seq 4096, 4096 "
                                       "source frames)")}
# paths whose unsharded references (1.81 G parameters: 29 GB with AdamW's
# state, fp32) the ranks run one at a time, behind a barrier
TP_TURNS = ("moonshot-v1-16b-a3b",)
TP_ENTRIES = ("mls_quantize_rows_amax", "mls_quantize_rows_codes")  # K1's split entries
# K1's split entries at training operands: chatglm3-6b's activation of a batch
# of 2 x 4096 and MLP up-projection weight, quantized as (N, K); zamba2-7b's
# rank shapes at a model axis of 2: the in_proj's w^T on rank 0 (z and x of 56
# heads, 7168, and the 240-wide tail) and rank 1, and rank 0's in_proj error
# (4096 tokens, the tail's ragged dt group padded: 7408 -> 7424)
TP_K1_SHAPES = {"x (8192, 4096)": (8192, 4096), "w^T (13696, 4096)": (13696, 4096),
                "zamba2 in_proj w^T rank 0 (7408, 3584)": (7408, 3584),
                "zamba2 in_proj w^T rank 1 (7168, 3584)": (7168, 3584),
                "zamba2 in_proj e rank 0 (4096, 7424)": (4096, 7424),
                # moonshot-v1-16b-a3b at model 2: wq's w^T (1024 of 2048 columns)
                # and wo's x (4096 tokens, 1024 of 2048 rows); seamless-m4t-medium:
                # w_up's w^T (2048 of d_ff 4096), w_down's x and the cross
                # attention's K/V error over 4096 source frames (512 of 1024)
                "moonshot wq w^T rank (1024, 2048)": (1024, 2048),
                "moonshot wo x rank (4096, 1024)": (4096, 1024),
                "seamless w_up w^T rank (2048, 1024)": (2048, 1024),
                "seamless w_down x rank (4096, 2048)": (4096, 2048),
                "seamless xattn wk e rank (4096, 512)": (4096, 512),
                # serving chatglm3-6b at model 2 (a decode step of 4 rows):
                # rank 0's w_up w^T (6912 of d_ff 13696, whole groups) and
                # its w_down x (4 rows, 6912 of 13696)
                "chatglm3 w_up w^T decode rank 0 (6912, 4096)": (6912, 4096),
                "chatglm3 w_down x decode rank 0 (4, 6912)": (4, 6912),
                # yi-34b at model 16 (1 x 512 tokens, TP16_PATHS): wq's w^T on rank 0
                # (4 heads of 128) and rank 15 (3), and wo's x on both
                "yi wq w^T rank 0 (512, 7168)": (512, 7168),
                "yi wq w^T rank 15 (384, 7168)": (384, 7168),
                "yi wo x rank 0 (512, 512)": (512, 512),
                "yi wo x rank 15 (512, 384)": (512, 384),
                # sequence parallelism at model 16 (TP16_SP_PATHS): seamless-m4t-medium's
                # whole attention on a rank's 128 of 2048 tokens, wq's x and the
                # weight gradient's x^T (the contraction over the tokens, one group)
                "seamless wq x own tokens (128, 1024)": (128, 1024),
                "seamless wq x^T own tokens (1024, 128)": (1024, 128)}
# fp32: JAX's own (data 2, model 2) mesh tolerance, relative on the loss, the
# grad norm and the rank's updated parameters as one vector (relative L2).
# Not per element or per tensor: AdamW's first step moves an element by up to
# lr whatever its gradient's size, so a gradient near AdamW's eps turns
# summation-order noise into most of a step (1.2e-4 on a few wk / wv
# elements at lr 3e-4), and a tensor whose exact gradient is 0 (the key
# bias's pass-through half, which softmax ignores) differs by its noise
# alone (13% relative); both are reported.
TP_AGREE = {"fp32": 1e-4,
            "pallas": 5e-2}  # the loss only: one moved code cascades (PR 19's unfed gap)
TP_LR = 3e-4  # a constant rate: the default schedule's step 0 has lr 0


def tp_k1_checks(gen) -> tuple[list[dict], list[dict]]:
    """K1's split entries (pass A, pass B over the given max) at
    TP_K1_SHAPES with rounding bytes: with the operand's own max bit for bit
    the one-call entry's and the plain version's; with a larger max (another
    rank's) quantize_ref's with that max.  Each entry timed (CUDA events,
    and its kernels alone) beside its byte bound, its plain version and,
    for pass A, torch.linalg.vector_norm(x, inf), one PyTorch call of the
    same max |x|."""
    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import autotune, mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_quantize import (
        quantize_launch, quantize_rows_split, rows_amax, rows_codes)
    from repro_torch.kernels.ref import quantize_ref

    checks, rows = [], []
    for sname, (M, K) in TP_K1_SHAPES.items():
        x = torch.randn((M, K), generator=gen, device="cuda")
        r = rounding_bytes((M, K), gen, x.device)
        config = autotune.resolve_block_config("quantize", (M, K), FMT_IMAGENET, "nc",
                                               k_block=128, device=x.device)
        _, (_, _, width, variant, parts) = quantize_launch(M, K, 128, "nc", config)
        one = mls_quantize(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc", config=config)
        split = quantize_rows_split(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc", config)
        plain = quantize_ref(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc")
        big = x.abs().amax() * 2.5
        given = quantize_rows_split(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc", config,
                                    lambda a: torch.full_like(a, float(big)))
        given_plain = quantize_ref(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc", amax=big)
        torch.cuda.synchronize()
        same = (all(torch.equal(a, b) and torch.equal(a, c)
                    for a, b, c in zip(split, one, plain))
                and all(torch.equal(a, b) for a, b in zip(given, given_plain)))
        err = max(max_abs_err(a, b) for a, b in zip((*split, *given), (*plain, *given_plain)))
        checks.append(dict(kernel="mls_quantize_rows_amax+codes", shape=sname, identical=same,
                           max_abs_err=err))
        amax = rows_amax(x, parts)
        n = M * K
        for name, fn, plain_fn, lib_fn, nbytes in (
                ("mls_quantize_rows_amax", lambda: rows_amax(x, parts),
                 lambda: x.abs().amax(), lambda: torch.linalg.vector_norm(x, float("inf")),
                 4 * n + 4 * parts + 4),
                ("mls_quantize_rows_codes",
                 lambda: rows_codes(x, r, amax, FMT_IMAGENET, width, variant),
                 lambda: quantize_ref(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc", amax=amax),
                 None, 4 * n + n + n + 4 * (n // width) + 8)):
            rows.append(dict(
                name=name, shape=f"{sname} nc stochastic, {variant}, {parts} partials",
                ms=cuda_ms(fn), kernel_ms=kernel_ms(fn, DEVICE_KERNELS[name]),
                plain_ms=cuda_ms(plain_fn, iters=5),
                library_ms=None if lib_fn is None else cuda_ms(lib_fn),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes,
                max_abs_err=err))
        del x, r, one, split, plain, given, given_plain, amax
        torch.cuda.empty_cache()
    return checks, rows


# K3 at zamba2-7b's rank-0 GEMMs at a model axis of 2 (4096 tokens): the
# in_proj forward over the rank's 7408 columns (z and x of 56 heads and the
# tail), and the out_proj forward over its 3584 rows of din; moonshot's wq
# and seamless's w_up, w_down and cross-attention wk forwards of a rank
TP_K3_SHAPES = {"zamba2 in_proj fwd rank 0": (4096, 3584, 7408),
                "zamba2 out_proj fwd rank 0": (4096, 3584, 3584),
                "moonshot wq fwd rank": (4096, 2048, 1024),
                "seamless w_up fwd rank": (4096, 1024, 2048),
                "seamless w_down fwd rank": (4096, 2048, 1024),
                "seamless xattn wk fwd rank": (4096, 1024, 512),
                # serving chatglm3-6b at model 2: a decode step's (4 rows) rank-0
                # w_up and w_down
                "chatglm3 w_up decode rank 0": (4, 4096, 6912),
                "chatglm3 w_down decode rank 0": (4, 6912, 4096),
                # yi-34b at model 16, 512 tokens: wq's and wo's forwards on rank 0
                # (4 heads) and rank 15 (3)
                "yi wq fwd rank 0": (512, 7168, 512),
                "yi wq fwd rank 15": (512, 7168, 384),
                "yi wo fwd rank 0": (512, 512, 7168),
                "yi wo fwd rank 15": (512, 384, 7168),
                # sequence parallelism at model 16: seamless's whole wq on a rank's
                # 128 tokens, forward and weight gradient (contracting the tokens)
                "seamless wq fwd own tokens": (128, 1024, 1024),
                "seamless wq wgrad own tokens": (1024, 128, 1024)}


def tp_k3_checks(gen) -> tuple[list[dict], list[dict]]:
    """K3 at TP_K3_SHAPES on K1's codes of random operands (stochastic):
    the plan matmul_plan picks and every other variant it accepts
    (k3_plans) bit for bit mls_matmul_ref's; the plan timed (CUDA events,
    and its kernels alone) beside its bound (the larger of its int8 ops and
    its bytes: both operands' codes and group scales read, the output
    written), its plain version, the other plans and torch._int_mm
    (k3_times)."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.ref import mls_matmul_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    checks, rows = [], []
    for sname, (M, K, N) in TP_K3_SHAPES.items():
        coded = []
        for n in (M, N):
            t = torch.randn((n, K), generator=gen, device="cuda")
            coded.append(mls_quantize(t, fmt, kb, GS_FMT_DEFAULT,
                                      rounding_bytes(t.shape, gen, t.device), "nc"))
            del t
        (xc, xsg, xst), (wc, wsg, wst) = coded
        args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        want = mls_matmul_ref(*args)
        plans = k3_plans(M, N, K, kb, fmt)
        plan = plans[0]
        got = [mls_matmul(*args, "nc", plan=p) for p in plans]
        torch.cuda.synchronize()
        err = max(max_abs_err(g, want) for g in got)
        checks.append(dict(kernel="mls_matmul", shape=sname, mkn=(M, K, N),
                           plan=dataclasses.asdict(plan), plans=[p.variant for p in plans],
                           identical=all(torch.equal(g, want) for g in got), max_abs_err=err))
        run = lambda: mls_matmul(*args, "nc", plan=plan)  # noqa: E731
        ops = 2 * M * N * K
        # codes and group scales of both operands read, the output written
        nbytes = M * K + N * K + 4 * (xsg.numel() + wsg.numel()) + 4 * M * N + 8
        bound_ops, bound_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(name="mls_matmul", shape=f"{sname} ({M}x{K}x{N}) {plan.variant}",
                         ms=cuda_ms(run), kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_matmul"]),
                         plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                         library_ms=None, bound_ms=max(bound_ops, bound_bytes),
                         bound_by="operations" if bound_ops >= bound_bytes else "bytes", ops=ops,
                         bytes=nbytes, max_abs_err=err, **k3_times(args, "nc", plans)))
        del coded, args, want, got
        torch.cuda.empty_cache()
    return checks, rows


def _tp_configs(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    cfg, layers = get_config(arch), TP_PATHS[arch][0]
    depth = {"n_layers": layers, **({"enc_layers": layers} if cfg.enc_layers else {})}
    q = dataclasses.replace(cfg, **depth, quant_backend="pallas")
    # unquantized in fp32, as JAX holds its own mesh: with bf16 activations
    # AdamW's first step turns rounding noise in tiny gradients into whole
    # steps of the other sign (a zero-initialised bias moved 18% apart)
    return {"fp32": dataclasses.replace(q, quant=False, compute_dtype="float32"), "pallas": q}


def _tp_unsharded_linears(params: dict, records: list) -> None:
    """Each recorded linear call of an unsharded step (its x, g and key) run
    unsharded on the model's ``params``, in place: the record gains its
    fp32 input ``x`` (the bf16 values; the quantizer reads fp32 either
    way, and the data gradient comes back unrounded), output ``y`` and
    gradients ``dx`` and ``dw``."""
    import torch

    from repro_torch.models import nn as L

    for rec in records:
        name, x = rec["name"], rec["x"].float()
        x0 = x.clone().requires_grad_()
        w0 = params[f"{name}.w"].detach().requires_grad_()
        bias = params.get(f"{name}.b")
        y = L.linear(x0, w0, None if bias is None else bias.detach(), rec["qcfg"], rec["key"])
        dx, dw = torch.autograd.grad(y, (x0, w0), rec["g"])
        rec.update(x=x, y=y.detach(), dx=dx, dw=dw)
        del x0, w0, y


def _tp_linear_checks(params: dict, records: list, layout, tp, seqs=None) -> list[dict]:
    """Each recorded linear call (:func:`_tp_unsharded_linears` filled in its
    unsharded ``y``, ``dx``, ``dw``) run by this rank's tensor-parallel
    linear on the same inputs, the unsharded weights ``params``: a split
    linear's slices bit for bit, its sum over the ranks within fp32's
    group-order bound (G_r + 1) eps max|ref|; a linear that stays whole (a
    replicated kv or attention linear) the unsharded one bit for bit.  A
    split of several pieces (a Mamba2 in_proj's) takes them all.
    ``seqs``: each call's sequence split under sequence parallelism (None:
    whole), as the model made the call: a row-parallel output is then the
    rank's tokens of the sum (reduce-scattered), within the same bound; a
    linear kept whole runs on the rank's tokens (token slices of the
    unsharded operands): its outputs and data gradient the unsharded rows
    bit for bit, its weight gradient summed over the ranks within
    (G + 1) eps max|ref|, G the scaling groups of the tokens."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import nn as L
    from repro_torch.parallel.tensor import Split, TPLinear, copy_to_tp

    eps = torch.finfo(torch.float32).eps
    out = []
    for rec, seq in zip(records, seqs or [None] * len(records)):
        name, x = rec["name"], rec["x"]
        w = params[f"{name}.w"].detach()
        bias = params.get(f"{name}.b")
        bias = None if bias is None else bias.detach()
        sp = layout.get(f"{name}.w")
        if sp is None and seq is not None:  # whole, run on the rank's tokens
            x1 = seq.take(x).contiguous().requires_grad_()
            w1 = w.clone().requires_grad_()
            yt = L.linear(x1, w1, bias, rec["qcfg"], rec["key"], None, seq.split())
            dxt, dwt = torch.autograd.grad(yt, (x1, w1), seq.take(rec["g"]).contiguous())
            exact = (torch.equal(yt, seq.take(rec["y"]))
                     and torch.equal(dxt, seq.take(rec["dx"])))
            dist.all_reduce(dwt, group=tp.group)
            groups = -(-x.shape[0] * x.shape[1] // 128)
            err = (dwt - rec["dw"]).abs().max().item()
            tol = (groups + 1) * eps * rec["dw"].abs().max().item()
            out.append(dict(linear=name, kind="tokens", slices_bit_identical=exact,
                            sum_err=err, sum_tol=tol, ok=exact and err <= tol))
            del x1, w1, yt, dxt, dwt
            continue
        if sp is None:  # whole on every rank
            x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
            yt = L.linear(x1, w1, bias, rec["qcfg"], rec["key"])
            dxt, dwt = torch.autograd.grad(yt, (x1, w1), rec["g"])
            exact = (torch.equal(yt, rec["y"]) and torch.equal(dxt, rec["dx"])
                     and torch.equal(dwt, rec["dw"]))
            out.append(dict(linear=name, kind="whole", slices_bit_identical=exact, sum_err=0.0,
                            sum_tol=0.0, ok=exact))
            del x1, w1, yt, dxt, dwt
            continue
        pieces = sp.pieces[tp.rank]
        last = Split(x.ndim - 1, (pieces,))  # the same pieces of an activation's last dim
        kind = "column" if sp.dim == 1 else "row"
        lin = TPLinear.of(kind, sp, tp)
        w1 = sp.take(w, tp.rank).contiguous().requires_grad_()
        if kind == "column":
            x1 = x.clone().requires_grad_()
            bt = None if bias is None else Split(0, (pieces,)).take(bias, 0)
            yt = lin(L.linear, copy_to_tp(x1, tp), w1, bt, rec["qcfg"], rec["key"], None)
            dxt, dwt = torch.autograd.grad(yt, (x1, w1), last.take(rec["g"], 0).contiguous())
            exact = (torch.equal(yt, last.take(rec["y"], 0))
                     and torch.equal(dwt, sp.take(rec["dw"], tp.rank)))
            summed, want = dxt, rec["dx"]
        else:
            x1 = last.take(x, 0).contiguous().requires_grad_()
            yt = lin(L.linear, x1, w1, bias, rec["qcfg"], rec["key"], None, seq)
            g = rec["g"] if seq is None else seq.take(rec["g"]).contiguous()
            dxt, dwt = torch.autograd.grad(yt, (x1, w1), g)
            exact = (torch.equal(dxt, last.take(rec["dx"], 0))
                     and torch.equal(dwt, sp.take(rec["dw"], tp.rank)))
            summed, want = yt, rec["y"] if seq is None else seq.take(rec["y"])
        groups = sum(-(-(b - a) // 128) for a, b in pieces)
        err = (summed.float() - want.float()).abs().max().item()
        tol = (groups + 1) * eps * want.float().abs().max().item()
        out.append(dict(linear=name, kind=kind, cols=pieces, slices_bit_identical=exact,
                        sum_err=err, sum_tol=tol, ok=exact and err <= tol))
        del x1, w1, yt, dxt, dwt
    return out


class _Unspy:
    """A handle whose ``remove`` drops an instance attribute that shadows a
    method (a spy)."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr

    def remove(self) -> None:
        delattr(self.obj, self.attr)


def _tp_record_linears(model):
    """Forward hooks on every quantized linear of the model's layers, its
    encoder's layers and its shared block (an MoE's router, called with no
    config, is not): each call's x, config, key and index among the
    linear's calls, and the gradient of its output once backward reaches
    it (the recomputed forward of remat gets no gradient: dropped).  On
    each MoE layer, its experts' calls (``MoE._experts``): the buffer xe,
    config and key, the gathered outputs and their gradient, likewise."""
    records, experts, handles = [], [], []
    calls = collections.Counter()
    for name, mod in model.named_modules():
        if not name.startswith(("layers.", "enc_layers.", "shared_attn.")):
            continue
        if type(mod).__name__ == "MoE":
            def spy(xe, qcfg, key, name=name, real=mod._experts):
                ye = real(xe, qcfg, key)
                rec = dict(name=name, xe=xe.detach(), qcfg=qcfg, key=key, ye=ye.detach())
                ye.register_hook(lambda g: rec.__setitem__("g", g.detach()))
                experts.append(rec)
                return ye
            mod._experts = spy
            handles.append(_Unspy(mod, "_experts"))
        elif type(mod).__name__ == "Linear":
            def hook(m, args, kwargs, out, name=name):
                if len(args) < 2 or args[1] is None:
                    return
                rec = dict(name=name, x=args[0].detach(), qcfg=args[1], key=args[2],
                           call=calls[name])
                calls[name] += 1
                out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
                records.append(rec)
            handles.append(mod.register_forward_hook(hook, with_kwargs=True))
    return records, experts, handles


def _sp_record_seqs(model):
    """Forward pre-hooks on the linears :func:`_tp_record_linears` records:
    each quantized call's sequence split (``seq``; None: whole), by linear
    in call order."""
    seqs, handles = collections.defaultdict(list), []
    for name, mod in model.named_modules():
        if (name.startswith(("layers.", "enc_layers.", "shared_attn."))
                and type(mod).__name__ == "Linear"):
            def hook(m, args, kwargs, name=name):
                if len(args) >= 2 and args[1] is not None:
                    seqs[name].append(kwargs.get("seq"))
            handles.append(mod.register_forward_pre_hook(hook, with_kwargs=True))
    return seqs, handles

def _tp_record_routing(model):
    """Forward hooks on every MoE router: each token's top-k experts
    (sorted) at its first call (remat's recomputed forward adds nothing)."""
    import torch

    routes, handles = {}, []
    for name, mod in model.named_modules():
        if name.endswith(".moe.router"):
            def hook(m, args, out, name=name):
                if name not in routes:
                    top = torch.topk(torch.softmax(out.detach().float(), dim=-1),
                                     model.cfg.top_k, dim=-1).indices
                    routes[name] = top.sort(dim=-1).values.cpu()
            handles.append(mod.register_forward_hook(hook))
    return routes, handles


def _route_flips(got: dict, ref: dict) -> dict[str, int]:
    """Tokens whose top-k experts differ between two runs, by router."""
    return {k: int((got[k] != ref[k]).any(dim=-1).sum()) for k in ref}


def _tp_unsharded_experts(ref, experts) -> list[dict]:
    """Each recorded MoE call's expert stack run unsharded on the recorded
    buffer and output gradient: the outputs, the buffer's gradient and the
    three weight gradients (before the model is made tensor-parallel)."""
    import torch

    out = []
    for rec in experts:
        moe = ref.get_submodule(rec["name"])
        xe = rec["xe"].clone().requires_grad_()
        ws = [moe.w_gate, moe.w_up, moe.w_down]
        ye = moe._stack(xe, rec["qcfg"], rec["key"], None)
        grads = torch.autograd.grad(ye, [xe, *ws], rec["g"])
        out.append(dict(ye=ye.detach(), dxe=grads[0], dws=grads[1:],
                        same_as_run=torch.equal(ye.detach(), rec["ye"])))
        del ye, grads, xe
    return out


def _tp_expert_checks(model, experts, full) -> list[dict]:
    """Each recorded MoE call's expert stack run by this rank's
    tensor-parallel MoE (``model`` made tensor-parallel, the ranks in step)
    on the unsharded call's buffer and output gradient, against the
    unsharded stack's (``full``, :func:`_tp_unsharded_experts`): this
    rank's outputs and weight gradients its slices, the gathered outputs
    and the buffer's gradient summed over the group whole, bit for bit."""
    import torch

    out = []
    for rec, want in zip(experts, full):
        moe = model.get_submodule(rec["name"])
        e0, e1 = moe.experts
        local = {}

        def spy(xe, qcfg, key, span, real=moe._stack):
            y = real(xe, qcfg, key, span)
            local["y"] = y.detach()
            return y

        moe._stack = spy
        xe = rec["xe"].clone().requires_grad_()
        ws = [moe.w_gate, moe.w_up, moe.w_down]
        ye = moe._experts(xe, rec["qcfg"], rec["key"])
        grads = torch.autograd.grad(ye, [xe, *ws], rec["g"])
        _Unspy(moe, "_stack").remove()
        checks = dict(outputs=torch.equal(local["y"], want["ye"][e0:e1]),
                      weight_grads=all(torch.equal(g, w[e0:e1])
                                       for g, w in zip(grads[1:], want["dws"])),
                      gathered=torch.equal(ye.detach(), want["ye"]),
                      buffer_grad=torch.equal(grads[0], want["dxe"]),
                      run=want["same_as_run"])
        out.append(dict(layer=rec["name"], experts=(e0, e1), **checks, ok=all(checks.values())))
        del ye, grads, xe, local
    return out


def tp_linears(cfg) -> int:
    """The quantized linear calls of one forward of ``cfg``'s model: 7 a
    dense layer or shared-block call (6 ungated), 2 a Mamba2 layer, 4 an
    MoE layer's attention and 3 its shared expert's MLP (2 ungated), a
    dense block an encoder layer, and 4 more a decoder layer (its
    cross-attention)."""
    mlp = 3 if cfg.gated_mlp else 2
    block = 4 + mlp
    if cfg.family == "dense":
        return block * cfg.n_layers
    if cfg.family == "moe":
        return (4 + (mlp if cfg.n_shared_experts else 0)) * cfg.n_layers
    if cfg.family == "encdec":
        return block * cfg.enc_layers + (4 + block) * cfg.n_layers
    return 2 * cfg.n_layers + (block * (cfg.n_layers // cfg.attn_every)
                               if cfg.family == "hybrid" else 0)


def _tp_reference(r: dict, tag: str, cfg, run, step_fn, opt_init, batch, layout, mine,
                  routes, rank: int):
    """The unsharded reference of one path and config on this rank's card,
    with no collective: the fp32 step (the rank's updated parameters held
    to it) or the quantized loss and backward (every linear's call and
    each MoE call recorded; each MoE call's stack run unsharded); the
    routing flips against the tensor-parallel step's.  Returns, quantized,
    the model, its linear records, its MoE records and their unsharded
    runs (fp32: None and nothing)."""
    from repro_torch.core import fold_in
    from repro_torch.models.lm import init_lm

    ref = init_lm(cfg, seed=0, device="cuda")
    ref_routes, route_handles = _tp_record_routing(ref)
    records, experts, full = [], [], []
    if tag == "fp32":
        ropt = opt_init(ref)
        ref, ropt, rm = step_fn(ref, ropt, batch)
        r.update(ref_loss=float(rm["loss"]), ref_grad_norm=float(rm["grad_norm"]))
        worst_abs, worst_rel, sq_diff, sq_want = (0.0, None), (0.0, None), 0.0, 0.0
        for k, p in ref.named_parameters():
            want = p.detach()
            if k in layout:
                want = layout[k].take(want, rank)
            diff = mine[k].double() - want.double()
            worst_abs = max(worst_abs, (diff.abs().max().item(), k), key=lambda v: v[0])
            rel = float(diff.norm() / max(float(want.double().norm()), 1e-30))
            worst_rel = max(worst_rel, (rel, k), key=lambda v: v[0])
            sq_diff += float(diff.square().sum())
            sq_want += float(want.double().square().sum())
        r.update(params_rel=math.sqrt(sq_diff / sq_want), params_worst_abs=worst_abs,
                 params_worst_rel=worst_rel)
        del ropt, ref
        ref = None
    else:
        records, experts, handles = _tp_record_linears(ref)
        loss, _ = ref.loss(batch, fold_in(run.seed, 0))  # the step's key at step 0
        loss.backward()
        for h in handles:
            h.remove()
        r["ref_loss"] = loss.item()
        del loss
        ref.zero_grad(set_to_none=True)
        records = [x for x in records if "g" in x]
        experts = [x for x in experts if "g" in x]
        full = _tp_unsharded_experts(ref, experts)
    for h in route_handles:
        h.remove()
    r["route_flips"] = _route_flips(routes, ref_routes)
    return ref, records, experts, full


def _tp_rank_work(rank: int) -> dict:
    """One rank of the model axis, for each path of TP_PATHS: the
    tensor-parallel step of each config (counts set to 0 just before the
    step and read just after), then the unsharded step (fp32) or loss
    (pallas, its linears and experts recorded) on the same card as the
    reference, side by side or, on TP_TURNS' paths, one rank at a time;
    quantized, the ranks in step then run each recorded linear
    tensor-parallel and each MoE layer's stack by the rank's
    tensor-parallel MoE on the reference's recorded buffer."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.tensor import TensorParallel, tensor_parallel
    from repro_torch.train import make_train_step

    tp = TensorParallel.of()
    out = {"rank": rank}
    for arch in TP_PATHS:
        out[arch] = {}
        for tag, cfg in _tp_configs(arch).items():
            run = RunConfig(model=cfg, shape=SHAPES["train_4k"])
            step_fn, opt_init = make_train_step(run, lr_fn=lambda step: TP_LR)
            batch = next(lm_train_data(cfg, TP_BATCH, TP_SEQ))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = tensor_parallel(init_lm(cfg, seed=0, device="cuda"), tp)
            opt = opt_init(model)
            layout = model.tp_layout
            routes, handles = _tp_record_routing(model)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            model, opt, m = step_fn(model, opt, batch)
            torch.cuda.synchronize()
            r = dict(first_step_ms=(time.perf_counter() - t0) * 1e3, launches=launch_counts(),
                     loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
            for h in handles:
                h.remove()
            mine = {k: p.detach().clone() for k, p in model.named_parameters()}
            t0 = time.perf_counter()  # a second step, warm, for its time alone
            model, opt, m = step_fn(model, opt, batch)
            torch.cuda.synchronize()
            r.update(step_ms=(time.perf_counter() - t0) * 1e3,
                     peak_memory_bytes=torch.cuda.max_memory_allocated())
            del model, opt, m
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            turns = range(tp.size) if arch in TP_TURNS else (rank,)
            for turn in turns:
                if turn == rank:
                    ref, records, experts, full = _tp_reference(
                        r, tag, cfg, run, step_fn, opt_init, batch, layout, mine, routes, rank)
                    torch.cuda.empty_cache()
                if len(turns) > 1:
                    dist.barrier()
            r["reference_s"] = time.perf_counter() - t0
            if ref is not None:  # the ranks in step: the split linears' collectives
                params, r["linears"] = dict(ref.named_parameters()), []
                for rec in records:  # one at a time: each holds a weight's gradient
                    _tp_unsharded_linears(params, [rec])
                    r["linears"] += _tp_linear_checks(params, [rec], layout, tp)
                    rec.clear()
            if experts:
                tensor_parallel(ref, tp)
                r["experts"] = _tp_expert_checks(ref, experts, full)
            del ref, mine, records, experts, full
            torch.cuda.empty_cache()
            out[arch][tag] = r
    t0 = time.perf_counter()
    out["sp"] = _sp_rank_work(rank, tp)
    out["sp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = _tp_serve_work(rank, tp)
    out["serve_s"] = time.perf_counter() - t0
    return out


# Sequence parallelism in the model-2 world (tensor_parallel(..., seq_shard=True),
# JAX's SP_RULES): SP_ARCH at TP_PATHS' cut, 1 x 4096, fp32 and K1/K3.  The SP
# loss and backward against the DEFAULT layout's on the same ranks: the loss and
# every split gradient bit for bit, the replicated ones (summed over the group
# from each rank's tokens) within SP_REPLICATED_TOL relative; against the
# unsharded model on the rank's card: fp32 the loss and the gradients (one
# vector, relative L2) within SP_AGREE["fp32"], quantized the loss within
# SP_AGREE["pallas"] and each recorded linear call fed the unsharded operands
# as the SP step made it (_tp_linear_checks with its sequence split: a
# row-parallel exit's rows of the reduce-scattered sum); a prefill of
# SP_PREFILL prompts against the DEFAULT prefill, logits and caches bit for bit;
# and one whole SP train step's peak against the dry run's prediction of it
# (DRYRUN_PEAK_TOL).
SP_ARCH = "chatglm3-6b"
SP_REPLICATED_TOL = 1e-6
# the SP loss against the unsharded one; quantized, tighter than TP_AGREE's
# unfed bound: seen on an H100, 6.85e-6 (SP_ARCH, model 2), 4.3e-7 and 0
# (TP16_SP_PATHS)
SP_AGREE = {"fp32": TP_AGREE["fp32"], "pallas": 1e-4}
SP_PREFILL = (4, 512)  # prompts, tokens
SP_KEY = 7


def _sp_grads(model) -> dict:
    """The model's gradients by name, the partial ones summed over the
    model group as the trainer sums them."""
    from repro_torch.train.trainer import sum_partial_grads

    return sum_partial_grads(model, {k: p.grad for k, p in model.named_parameters()
                                     if p.grad is not None})


def _sp_rank_work(rank: int, tp) -> dict:
    """This rank's sequence-parallel checks of SP_ARCH (see above): per
    config, the loss and backward under SP and DEFAULT (counts set to 0
    just before the SP one, read just after), their comparison, the
    prefills, the unsharded reference (quantized: its linear calls
    recorded, then fed to the SP step's linears one at a time); quantized,
    first a whole SP train step (AdamW) for its peak memory."""
    import torch

    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.tensor import tensor_parallel
    from repro_torch.train import make_train_step

    out = {}
    for tag, cfg in _tp_configs(SP_ARCH).items():
        batch = next(lm_train_data(cfg, TP_BATCH, TP_SEQ))
        r = {}
        if tag == "pallas":  # the dry run's prediction holds the step alone on the card
            gc.collect()
            torch.cuda.empty_cache()
            step_fn, opt_init = make_train_step(RunConfig(model=cfg, shape=SHAPES["train_4k"]),
                                                lr_fn=lambda step: TP_LR)
            model = tensor_parallel(init_lm(cfg, seed=0, device="cuda"), tp, seq_shard=True)
            opt = opt_init(model)
            # the step's arguments (parameters, AdamW's moments, the batch), as the
            # dry run counts them; anything else alive is held beside the step
            args = sum(t.untyped_storage().nbytes() for t in (
                *model.parameters(), *opt.mu.values(), *opt.nu.values(), *batch.values()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() - args
            t0 = time.perf_counter()
            model, opt, m = step_fn(model, opt, batch)
            torch.cuda.synchronize()
            r.update(step_ms=(time.perf_counter() - t0) * 1e3, step_loss=float(m["loss"]),
                     step_peak_bytes=torch.cuda.max_memory_allocated() - held,
                     step_held_bytes=held)
            del model, opt, m
            gc.collect()
            torch.cuda.empty_cache()
        runs = {}
        for sp in (False, True):  # each peak above what the run found alive (DEFAULT's model)
            model = tensor_parallel(init_lm(cfg, seed=0, device="cuda"), tp, seq_shard=sp)
            if sp:
                seqs, handles = _sp_record_seqs(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss = model.loss(batch, SP_KEY)[0]  # no metrics kept: they hold the graph
            loss.backward()
            torch.cuda.synchronize()
            runs[sp] = dict(model=model, loss=loss.detach(), grads=_sp_grads(model),
                            launches=launch_counts(), ms=(time.perf_counter() - t0) * 1e3,
                            peak=torch.cuda.max_memory_allocated() - start,
                            split=dict(model.seq_split))
            del loss, model
        for h in handles:
            h.remove()
        d, p = runs[False], runs[True]
        layout = d["model"].tp_layout
        r.update(loss=p["loss"].item(), default_loss=d["loss"].item(),
                 loss_equal=bool(torch.equal(p["loss"], d["loss"])), launches=p["launches"],
                 split=p["split"], ms=p["ms"], default_ms=d["ms"], peak_bytes=p["peak"],
                 default_peak_bytes=d["peak"],
                 split_differ=[k for k in layout if not torch.equal(p["grads"][k], d["grads"][k])])
        rel = {k: float((p["grads"][k].double() - g.double()).norm()
                        / max(float(g.double().norm()), 1e-30))
               for k, g in d["grads"].items() if k not in layout}
        r["replicated_worst"] = max(((v, k) for k, v in rel.items()), default=(0.0, None))
        gen = torch.Generator(device="cuda").manual_seed(41)
        prompts = {"tokens": torch.randint(0, cfg.vocab, SP_PREFILL, generator=gen,
                                           device="cuda")}
        pre = [runs[sp]["model"].prefill(prompts, SP_PREFILL[1]) for sp in (False, True)]
        r["prefill_equal"] = bool(torch.equal(pre[0][0], pre[1][0]) and all(
            torch.equal(pre[0][1][k], pre[1][1][k]) for k in pre[0][1] if k != "pos"))
        r["prefill_gap"] = float((pre[1][0] - pre[0][0]).abs().max())
        grads = p["grads"]
        del runs, d, p, pre
        gc.collect()
        torch.cuda.empty_cache()
        ref = init_lm(cfg, seed=0, device="cuda")
        records, _, handles = _tp_record_linears(ref) if tag == "pallas" else ([], [], [])
        loss = ref.loss(batch, SP_KEY)[0]
        loss.backward()
        for h in handles:
            h.remove()
        r["ref_loss"] = loss.item()
        if tag == "pallas":  # the ranks in step: the linears' collectives
            params, r["linears"] = dict(ref.named_parameters()), []
            for rec in records:  # one at a time: each holds a weight's gradient
                if "g" not in rec:
                    continue
                _tp_unsharded_linears(params, [rec])
                r["linears"] += _tp_linear_checks(params, [rec], layout, tp,
                                                  [seqs[rec["name"]][rec["call"]]])
                rec.clear()
            del params, records
        if tag == "fp32":
            diff = want = 0.0
            for k, q in ref.named_parameters():
                g = q.grad if k not in layout else layout[k].take(q.grad, rank)
                diff += float((grads[k].double() - g.double()).square().sum())
                want += float(g.double().square().sum())
            r["grads_rel"] = math.sqrt(diff / want)
            del q, g
        del ref, loss, grads
        gc.collect()
        torch.cuda.empty_cache()
        out[tag] = r
    return out


def _sp_checks(ranks: list, predicted: int, smi: str, bad: list) -> dict:
    """The model-2 world's sequence-parallel results held (see
    _sp_rank_work); returns the record and prints each rank's numbers."""
    cfgs = _tp_configs(SP_ARCH)
    want = lm_train_launches(cfgs["pallas"], model_axis=TP_AXIS)
    rec = {}
    for r in ranks:
        for tag in ("fp32", "pallas"):
            t = r["sp"][tag]
            if not t["loss_equal"] or t["split_differ"]:
                bad.append(f"sp {tag} rank {r['rank']}: loss {t['loss']} vs DEFAULT "
                           f"{t['default_loss']}, split gradients differ {t['split_differ'][:4]}")
            if t["replicated_worst"][0] > SP_REPLICATED_TOL:
                bad.append(f"sp {tag} rank {r['rank']}: replicated {t['replicated_worst']}")
            if t["split"] != {"dec": True, "enc": False}:
                bad.append(f"sp {tag} rank {r['rank']}: sequence not split {t['split']}")
            gap = abs(t["loss"] - t["ref_loss"]) / abs(t["ref_loss"])
            t["ref_gap"] = gap
            if not math.isfinite(t["loss"]) or gap > SP_AGREE[tag]:
                bad.append(f"sp {tag} rank {r['rank']}: loss {t['loss']} vs unsharded "
                           f"{t['ref_loss']}")
            if tag == "fp32" and t["grads_rel"] > SP_AGREE["fp32"]:
                bad.append(f"sp fp32 rank {r['rank']}: gradients {t['grads_rel']} off unsharded")
            if tag == "pallas":
                wrong = [c for c in t["linears"] if not c["ok"]]
                if wrong or len(t["linears"]) != tp_linears(cfgs["pallas"]):
                    bad.append(f"sp pallas rank {r['rank']}: linears {wrong[:3]} of "
                               f"{len(t['linears'])}")
            if not t["prefill_equal"]:
                bad.append(f"sp {tag} rank {r['rank']}: prefill differs from DEFAULT's "
                           f"({t['prefill_gap']})")
            got = {k: t["launches"].get(k, 0) for k in want} if tag == "pallas" else (
                {k: n for k, n in t["launches"].items() if n})
            if got != (want if tag == "pallas" else {}):
                bad.append(f"sp {tag} rank {r['rank']} launches {got}, expected {want}")
            print(f"tensor sp {SP_ARCH} rank {r['rank']} {tag} ({smi}; gloo through the host on "
                  f"one card: not an SP speed): loss {t['loss']} (DEFAULT {t['default_loss']}, "
                  f"equal {t['loss_equal']}; unsharded gap {gap:.3g}"
                  + (f", gradients {t['grads_rel']:.3g}" if tag == "fp32" else
                     f", {len(t['linears'])} linear calls fed, worst sum "
                     f"{max(c['sum_err'] / max(c['sum_tol'], 1e-30) for c in t['linears']):.3g}"
                     f" of its bound")
                  + f"), replicated worst {t['replicated_worst']}, loss+backward "
                  f"{t['ms']:.1f} ms (DEFAULT {t['default_ms']:.1f}), peak above what it found "
                  f"alive {t['peak_bytes'] / 2**30:.3f} GiB (DEFAULT "
                  f"{t['default_peak_bytes'] / 2**30:.3f}), prefill equal {t['prefill_equal']}")
    step = ranks[0]["sp"]["pallas"]
    measured = step["step_peak_bytes"]
    err = abs(predicted - measured) / measured
    if err > DRYRUN_PEAK_TOL:
        bad.append(f"sp step peak predicted {predicted} vs measured {measured} ({err:.3g})")
    print(f"tensor sp {SP_ARCH} ({smi}): one SP train step's peak on rank 0 "
          f"{measured / 2**30:.3f} GiB (less {step['step_held_bytes'] / 2**30:.3f} GiB held "
          f"beside its arguments), the dry run's prediction (trace_step, seq_shard) "
          f"{predicted / 2**30:.3f} GiB: {err:.3%} (tolerance {DRYRUN_PEAK_TOL:.0%}); step "
          f"{step['step_ms']:.1f} ms")
    rec.update(expected_launches=want, predicted_peak_bytes=predicted,
               measured_peak_bytes=measured, held_bytes=step["step_held_bytes"], peak_err=err)
    return rec


# Serving each TP_PATHS path at a model axis of 2 (after its training
# checks): TP_SERVE_BATCH prompts of TP_SERVE_PROMPT tokens (the
# encoder-decoder's over TP_SERVE_SRC frames), then TP_SERVE_STEPS decode
# steps teacher-forced on the unsharded engine's greedy tokens, same weights;
# fp32 and "pallas" (K1/K3, bf16, nearest rounding).  TP_SERVE_AGREE: every
# step's logits against the unsharded engine's, relative L2, fp32 and
# "pallas" with each quantized linear (and MoE layer) fed the unsharded
# run's input and each row-parallel output held and replaced (_tp_feed);
# the unfed "pallas" gap is reported, not held (one ulp of a row-parallel
# sum before a quantizer moves a code).  Feeding the inputs alone left
# the bf16 residual stream to carry the row-parallel sums' ulps, which
# now and then round to the other bf16 neighbour: 2.2e-4 over seamless's
# 36 layers on the H100.
TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_SERVE_SRC, TP_SERVE_STEPS = 4, 512, 1024, 8
TP_SERVE_AGREE = 1e-4


_ROW_LINEARS = (".wo", ".w_down", ".out_proj")  # row-parallel under tensor parallelism


def _tp_feed(model, records: dict | None = None):
    """Hooks on every linear of the layers, the encoder's layers and the
    shared block, and on every MoE layer.  With no ``records``: each
    call's input, and each row-parallel linear's output, by (name, call)
    into a new dict.  With them (an unsharded run's), each call of this
    tensor-parallel model takes the recorded input in place of its own (a
    row-parallel linear its rank's pieces), and each row-parallel linear's
    output, its sum over the group, is held against the recorded output
    within (G_r + 1) eps max|ref| (G_r: the rank's scaling groups, the
    bound of the training checks, _tp_linear_checks) and replaced by it,
    so that its ulps do not reach the bf16 residual stream.  Returns the
    records, the hooks' handles and the held outputs' checks."""
    import collections

    import torch

    from repro_torch.parallel.tensor import Split

    out = {} if records is None else records
    calls: collections.Counter = collections.Counter()
    handles, checks = [], []
    eps = torch.finfo(torch.float32).eps
    for name, mod in model.named_modules():
        if (not name.startswith(("layers.", "enc_layers.", "shared_attn."))
                or type(mod).__name__ not in ("Linear", "MoE")):
            continue

        def pre(m, args, name=name):
            key = (name, calls[name])
            calls[name] += 1
            m._feed_key = key
            if records is None:
                out[key] = args[0].detach().clone()
                return None
            x = records[key]
            tp = getattr(m, "tp", None)
            if type(m).__name__ == "Linear" and tp is not None and tp.kind == "row":
                x = Split(x.ndim - 1, (tp.pieces,)).take(x, 0)
            return (x,) + tuple(args[1:])

        def post(m, args, y, name=name):
            key = (name, "out", m._feed_key[1])
            if records is None:
                out[key] = y.detach().clone()
                return None
            want = records[key]
            groups = sum(-(-(b - a) // 128) for a, b in m.tp.pieces)
            err = (y.float() - want.float()).abs().max().item()
            tol = (groups + 1) * eps * want.float().abs().max().item()
            checks.append(dict(linear=name, call=key[2], err=err, tol=tol, ok=err <= tol))
            return want
        handles.append(mod.register_forward_pre_hook(pre))
        if name.endswith(_ROW_LINEARS) and (records is None or getattr(mod, "tp", None)):
            handles.append(mod.register_forward_hook(post))
    return out, handles, checks


def _tp_serve_run(engine, batch, forced) -> dict:
    """A prefill of ``batch`` and one decode step per column of ``forced``
    (B, n) through ``engine``: each step's fp32 logits (B, vocab) stacked,
    its greedy tokens, its host-clock ms after a device sync, and its K1 /
    K3 launches by entry point."""
    import torch

    from repro_torch.kernels import launch_counts

    logits, ms, launched = [], [], []
    with torch.inference_mode():
        for i in range(forced.shape[1] + 1):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                lg, cache = engine.prefill(batch)
            else:
                lg, cache = engine.decode(cache, forced[:, i - 1:i])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            now = launch_counts()
            launched.append({k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)})
            logits.append(lg.float())
    logits = torch.stack(logits)
    return dict(logits=logits, tokens=logits.argmax(dim=-1), ms=ms, launches=launched)


def _step_rel(got, want) -> list[float]:
    """Each step's relative L2 distance of ``got`` from ``want`` (steps on
    dim 0)."""
    d = (got.double() - want.double()).flatten(1).norm(dim=1)
    return (d / want.double().flatten(1).norm(dim=1).clamp_min(1e-30)).tolist()


def _tp_unsharded_serve(cfg, full, batch, max_len: int, steps: int, tag: str) -> dict:
    """The unsharded engine's greedy run of ``full`` (its prefill of
    ``batch``, then ``steps`` decode steps, one at a time): the tokens to
    force on a tensor-parallel engine, every step's fp32 logits and,
    quantized, its linears' inputs and row-parallel outputs (_tp_feed)."""
    import torch

    from repro_torch.serve import ServeEngine

    records, handles, _ = _tp_feed(full) if tag == "pallas" else (None, [], [])
    engine = ServeEngine(cfg, full, max_len=max_len, device="cuda")
    with torch.inference_mode():
        lg, cache = engine.prefill(batch)
        greedy, ref_logits = [lg.argmax(dim=-1)[:, None]], [lg.float()]
        for _ in range(steps):
            lg, cache = engine.decode(cache, greedy[-1])
            greedy.append(lg.argmax(dim=-1)[:, None])
            ref_logits.append(lg.float())
    for h in handles:
        h.remove()
    return dict(forced=torch.cat(greedy[:-1], dim=1), logits=torch.stack(ref_logits),
                records=records)


def _tp_serve_case(cfg, model, batch, ref: dict, max_len: int, tag: str) -> dict:
    """This rank's tensor-parallel engine of ``model`` teacher-forced on the
    unsharded run ``ref``'s tokens (:func:`_tp_unsharded_serve`), unfed
    (counts set to 0 just before, read just after) and, quantized, fed:
    the logits' gaps per step, the tokens, the step times and launches,
    and the held row-parallel outputs."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, model, max_len=max_len)
    torch.cuda.synchronize()
    reset_launch_counts()
    run = _tp_serve_run(engine, batch, ref["forced"])
    launches = launch_counts()
    r = dict(launches={k: n for k, n in launches.items() if n},
             step_launches=run["launches"], prefill_ms=run["ms"][0],
             decode_ms=run["ms"][1:], gap=_step_rel(run["logits"], ref["logits"]),
             tokens=run["tokens"].tolist(), forced=ref["forced"].tolist(),
             greedy_equal=float((run["tokens"][:-1].t() == ref["forced"]).float().mean()),
             finite=bool(torch.isfinite(run["logits"]).all()))
    if tag == "pallas":
        _, handles, held = _tp_feed(model, ref["records"])
        fed = _tp_serve_run(engine, batch, ref["forced"])
        for h in handles:
            h.remove()
        r["fed_gap"] = _step_rel(fed["logits"], ref["logits"])
        r["fed_rows"] = dict(calls=len(held), bad=[c for c in held if not c["ok"]],
                             worst=max(c["err"] / max(c["tol"], 1e-30) for c in held))
        del fed, held
    del engine, run
    return r


def _tp_serve_work(rank: int, tp) -> dict:
    """One rank's serving of each TP_PATHS path (module docstring, phase
    15): per config, the unsharded engine's greedy run on the rank's card
    (:func:`_tp_unsharded_serve`), then the tensor-parallel engine
    teacher-forced on its tokens (:func:`_tp_serve_case`)."""
    import torch

    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.tensor import tensor_parallel

    out = {}
    for arch in TP_PATHS:
        out[arch] = {}
        for tag, cfg in _tp_configs(arch).items():
            gen = torch.Generator(device="cuda").manual_seed(29)
            tokens = torch.randint(0, cfg.vocab, (TP_SERVE_BATCH, TP_SERVE_PROMPT), generator=gen,
                                   device="cuda")
            batch = lm_inputs(cfg, tokens, gen, TP_SERVE_SRC)
            max_len = TP_SERVE_PROMPT + TP_SERVE_STEPS + 1
            torch.cuda.empty_cache()
            full = init_lm(cfg, seed=0, device="cuda")
            ref = _tp_unsharded_serve(cfg, full, batch, max_len, TP_SERVE_STEPS, tag)
            del full
            torch.cuda.empty_cache()
            model = tensor_parallel(init_lm(cfg, seed=0, device="cuda"), tp)
            out[arch][tag] = _tp_serve_case(cfg, model, batch, ref, max_len, tag)
            del model, ref
            torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, world: int, port: int, out: str) -> None:
    """One rank of the 2-rank model axis on cuda:0 over gloo (NCCL takes one
    card a rank)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.runtime import resolve_device

    torch.cuda.set_device(0)
    resolve_device("cuda")  # TF32 off
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        torch.save(_tp_rank_work(rank), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def phase_tensor(results: dict) -> tuple[dict[str, dict[str, int]], list[dict]]:
    """Tensor parallelism over the model axis (module docstring, phase 15);
    returns each path's launches (rank 0's) and the timing rows."""
    import concurrent.futures
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.sweep.record import nvidia_smi

    smi = nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(23)
    checks, rows = tp_k1_checks(gen)
    k3_checks, k3_rows = tp_k3_checks(gen)
    checks, rows = checks + k3_checks, rows + k3_rows
    torch.cuda.empty_cache()
    # the dry run's prediction of the SP step, traced beside the ranks' work
    trace = concurrent.futures.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    predicted = trace.submit(_dryrun_job, ("sp_step",))
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "tp")
        mp.spawn(_tp_rank, args=(TP_AXIS, _free_port(), out), nprocs=TP_AXIS, join=True)
        ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(TP_AXIS)]
    predicted, trace_launched = predicted.result()
    trace.shutdown()
    res = dict(batch=TP_BATCH, seq=TP_SEQ, model_axis=TP_AXIS, nvidia_smi=smi, k1_checks=checks,
               ranks=ranks, paths={})
    results["tensor"] = res
    res["timing"] = rows  # K1's split entries and K3 at the paths' rank shapes
    for row in rows:
        print(json.dumps({"timing": row}))
    bad = [c for c in checks if not c["identical"]]
    bad = [f"K1's split entries differ: {bad}"] if bad else []
    for arch, (layers, cut) in TP_PATHS.items():
        cfgs = _tp_configs(arch)
        want = lm_train_launches(cfgs["pallas"], model_axis=TP_AXIS)
        res["paths"][arch] = dict(layers=layers, cut=cut, expected_launches=want)
        for r in ranks:
            for tag in ("fp32", "pallas"):
                t = r[arch][tag]
                print(f"tensor {arch} rank {r['rank']} {tag} (gloo through the host on one "
                      f"card: not a TP speed; {smi}): step 2 {t['step_ms']:.1f} ms (step 1 "
                      f"{t['first_step_ms']:.1f}), peak {t['peak_memory_bytes'] / 2**30:.2f} "
                      f"GiB, loss {t['loss']} vs unsharded {t['ref_loss']}")
        for r in ranks:
            f, q = r[arch]["fp32"], r[arch]["pallas"]
            for what, got, ref in (("loss", f["loss"], f["ref_loss"]),
                                   ("grad norm", f["grad_norm"], f["ref_grad_norm"])):
                if abs(got - ref) > TP_AGREE["fp32"] * abs(ref):
                    bad.append(f"{arch} rank {r['rank']} fp32 {what} {got} vs {ref}")
            if f["params_rel"] > TP_AGREE["fp32"]:
                bad.append(f"{arch} rank {r['rank']} fp32 updated parameters {f['params_rel']}")
            gap = abs(q["loss"] - q["ref_loss"]) / abs(q["ref_loss"])
            q["loss_gap"] = gap
            if not (math.isfinite(q["loss"]) and gap <= TP_AGREE["pallas"]):
                bad.append(f"{arch} rank {r['rank']} quantized loss {q['loss']} vs "
                           f"{q['ref_loss']}")
            wrong = [c for c in q["linears"] if not c["ok"]]
            if wrong or len(q["linears"]) != tp_linears(cfgs["pallas"]):
                bad.append(f"{arch} rank {r['rank']} linears {wrong} of {len(q['linears'])}")
            if cfgs["pallas"].family == "moe":
                stacks = q.get("experts", [])
                if len(stacks) != cfgs["pallas"].n_layers or not all(c["ok"] for c in stacks):
                    bad.append(f"{arch} rank {r['rank']} expert stacks {stacks}")
            got = {k: q["launches"].get(k, 0) for k in want}
            if got != want:
                bad.append(f"{arch} rank {r['rank']} launches {got}, expected {want}")
        print(f"tensor ({smi}): {arch} {cut}, model axis {TP_AXIS} on cuda:0 over gloo: "
              f"quantized loss gap {[r[arch]['pallas']['loss_gap'] for r in ranks]}, fp32 "
              f"parameters {[r[arch]['fp32']['params_rel'] for r in ranks]} (worst element "
              f"{[r[arch]['fp32']['params_worst_abs'] for r in ranks]}, worst tensor "
              f"{[r[arch]['fp32']['params_worst_rel'] for r in ranks]}), launches {want} per "
              f"rank")
        if cfgs["pallas"].family == "moe":  # reported, not held: a near-tie may flip
            print(f"tensor ({smi}): {arch} tokens routed otherwise than unsharded, by rank: "
                  f"fp32 {[r[arch]['fp32']['route_flips'] for r in ranks]}, quantized "
                  f"{[r[arch]['pallas']['route_flips'] for r in ranks]}; expert stacks "
                  f"{[[c['ok'] for c in r[arch]['pallas']['experts']] for r in ranks]} "
                  f"(outputs, weight gradients, gather, buffer gradient bit for bit)")
    if trace_launched:
        bad.append(f"the SP step's trace launched {trace_launched}")
    res["sp"] = _sp_checks(ranks, predicted["peak_bytes"], smi, bad)
    res["sp_s"] = [r["sp_s"] for r in ranks]
    served = _tp_serve_checks(ranks, smi, bad)
    res["serve_s"] = [r["serve_s"] for r in ranks]
    t = time.perf_counter()
    res["model16"] = tensor16(smi, bad)
    res["model16_s"] = time.perf_counter() - t
    if bad:
        raise AssertionError("; ".join(bad))
    launches = {**{arch: ranks[0][arch]["pallas"]["launches"] for arch in TP_PATHS}, **served,
                f"{SP_ARCH} sp": ranks[0]["sp"]["pallas"]["launches"]}
    launches.update({f"{a} model 16": n for a, n in res["model16"]["launches"].items()})
    return launches, rows


def _tp_serve_checks(ranks: list, smi: str, bad: list) -> dict[str, dict[str, int]]:
    """The tensor phase's serving (:func:`_tp_serve_work`) held: every
    step's logits within TP_SERVE_AGREE of the unsharded engine's, fp32
    and quantized fed (the unfed gap printed), finite, the greedy tokens
    the same on both ranks, and rank 0's K1 / K3 launches of the prefill
    and of each decode step the closed form (serve_launches; none
    unquantized).  Prints each rank's prefill and decode ms.  Returns rank
    0's launches of each path's quantized serving run, by "<arch> serve"."""
    out = {}
    for arch in TP_PATHS:
        q = _tp_configs(arch)["pallas"]
        want = [serve_launches(q, model_axis=TP_AXIS, prefill=True)] + [
            serve_launches(q, model_axis=TP_AXIS)] * TP_SERVE_STEPS
        want = [{k: n for k, n in w.items() if n} for w in want]
        for r in ranks:
            for tag in ("fp32", "pallas"):
                t = r["serve"][arch][tag]
                fed = (f", fed {max(t['fed_gap']):.3g} ({t['fed_rows']['calls']} row-parallel "
                       f"outputs held, worst err / tol {t['fed_rows']['worst']:.3g})"
                       if "fed_gap" in t else "")
                print(f"tensor serve {arch} rank {r['rank']} {tag} (gloo through the host on one "
                      f"card: not a TP speed; {smi}): prefill {TP_SERVE_BATCH} x "
                      f"{TP_SERVE_PROMPT} {t['prefill_ms']:.1f} ms, decode "
                      f"{statistics.median(t['decode_ms']):.2f} ms/step median "
                      f"({TP_SERVE_STEPS} steps); logits gap to unsharded max "
                      f"{max(t['gap']):.3g}{fed}; greedy tokens equal to unsharded "
                      f"{t['greedy_equal']:.3f}")
                held = t["gap"] if tag == "fp32" else t["fed_gap"]
                if not (t["finite"] and max(held) <= TP_SERVE_AGREE):
                    bad.append(f"serve {arch} rank {r['rank']} {tag}: logits gap {max(held)} "
                               f"(finite {t['finite']})")
                if tag == "pallas" and (t["fed_rows"]["bad"] or not t["fed_rows"]["calls"]):
                    bad.append(f"serve {arch} rank {r['rank']}: row-parallel outputs off the "
                               f"unsharded ones {t['fed_rows']['bad'][:3]}")
                if t["tokens"] != ranks[0]["serve"][arch][tag]["tokens"]:
                    bad.append(f"serve {arch} {tag}: rank {r['rank']}'s tokens differ from rank "
                               f"0's")
        r0 = ranks[0]["serve"][arch]
        if r0["pallas"]["step_launches"] != want:
            bad.append(f"serve {arch} launches per step {r0['pallas']['step_launches']}, "
                       f"expected {want}")
        if r0["fp32"]["launches"]:
            bad.append(f"serve {arch} fp32 launched {r0['fp32']['launches']}")
        out[f"{arch} serve"] = r0["pallas"]["launches"]
    return out



# ---------------------------------------------------------------------------
# phase 15, part 2: the production model axis of 16 on one card
# ---------------------------------------------------------------------------
# 16 gloo processes on cuda:0, the three layouts the axis forces at full
# width, 1 x 512 tokens (seamless-m4t-medium 128).  This process runs each
# path's unsharded references once, a path at a time, and hands them to the
# ranks with the unsharded weights (CUDA IPC: one copy on the card); a rank
# builds its shards only (its model made on the meta device).
# A rank runs the step's loss and backward, no optimizer update (AdamW's
# state is not part of the layout), held to the unsharded loss, gradient
# norm and gradients.
TP16_AXIS, TP16_BATCH, TP16_SEQ, TP16_KEY = 16, 1, 512, 7
TP16_PATHS = {  # path: (config overrides, training tokens, cut)
    "yi-34b": ({"n_layers": 1}, TP16_SEQ,
               "n_layers 60 -> 1: 56 query heads of 128 split 4 / 3 in whole heads (8 ranks "
               "each), the 8 kv heads whole on every rank, each rank's heads reading theirs "
               "(rank 1's heads 4-7: kv 0, 0, 0, 1); train_4k's global batch 256 x 4096 -> 1 "
               "x 512"),
    "seamless-m4t-medium": ({"n_layers": 1, "enc_layers": 1}, 128,
                            "12 + 12 layers -> 1 + 1, over 512 frames: heads of 64 in 8 units "
                            "of 128, fewer than 16 ranks, so the self- and cross-attention stay "
                            "whole; the vocabulary of 256206 whole, emb and lm_head shared by "
                            "the 16 ranks from one copy and frozen in training (16 copies with "
                            "their gradients, 67 GB, do not fit one card), and 1 x 128 tokens "
                            "trained (16 ranks' whole logits of 512 tokens and their backward, "
                            "~2 GB a rank, did not fit beside 16 CUDA contexts)"),
    "mamba2-370m": ({"n_layers": 2}, TP16_SEQ,
                    "48 layers -> 2: the tied vocabulary of 50280 whole on every rank (16 does "
                    "not divide it); 1 x 512"),
}
# sequence parallelism at the model axis of 16 (tensor_parallel(..., seq_shard=
# True)): path -> (config overrides, tokens, source frames, cut).  Each rank's
# SP loss and backward against the unsharded one: fp32 the loss, the grad norm
# and the gradients (the partial ones summed over the group), quantized the
# loss, within SP_AGREE, and each recorded linear call fed as the SP step made
# it (_tp_linear_checks with its sequence split); the launches of ranks
# TP16_HELD the closed form with the sequences the step split.
TP16_SP_PATHS = {
    "mamba2-370m": ({"n_layers": 2}, 2048, 0,
                    "48 layers -> 2; 1 x 2048, 128 tokens a rank; the tied vocabulary of "
                    "50280 whole on every rank, its head and loss on the rank's tokens"),
    "seamless-m4t-medium": ({"n_layers": 1, "enc_layers": 1}, 2048, 512,
                            "12 + 12 layers -> 1 + 1; 1 x 2048 over 512 frames: the attention "
                            "(heads of 64, too few units for 16 ranks) whole, run on the "
                            "rank's 128 tokens with K/V gathered; on K1/K3 the encoder's 32 "
                            "frames a rank are not a scaling group, so its sequence stays "
                            "whole (fp32: split); the vocabulary of 256206 whole, shared and "
                            "frozen as above, its head and loss on the rank's tokens"),
}
TP16_SHARED = {"seamless-m4t-medium": ("emb", "lm_head")}  # one copy on the card, frozen
TP16_SERVE_BATCH, TP16_SERVE_PROMPT, TP16_SERVE_STEPS = 2, 128, 4
TP16_HELD = (0, TP16_AXIS - 1)  # the ranks whose launches are held to the closed forms


def _tp16_configs(arch: str, paths: dict = TP16_PATHS) -> dict:
    import dataclasses

    from repro_torch.configs import get_config

    q = dataclasses.replace(get_config(arch), **paths[arch][0], quant_backend="pallas")
    return {"fp32": dataclasses.replace(q, quant=False, compute_dtype="float32"), "pallas": q}


def _tp16_reference(arch: str) -> dict:
    """One TP16 path's unsharded references, on this process's card: the
    weights (seed 0), the batch, per config the loss and (fp32) every
    gradient or (quantized) each recorded linear call with its unsharded
    y, dx and dw (:func:`_tp_unsharded_linears`), and the unsharded
    engine's greedy serving of TP16_SERVE_BATCH prompts
    (:func:`_tp_unsharded_serve`)."""
    import torch

    from repro_torch.models.lm import init_lm

    cfgs = _tp16_configs(arch)
    out = {"cfgs": cfgs, "shared": TP16_SHARED.get(arch, ()),
           "batch": next(lm_train_data(cfgs["fp32"], TP16_BATCH, TP16_PATHS[arch][1]))}
    gen = torch.Generator(device="cuda").manual_seed(29)
    if "src_emb" in out["batch"]:  # the encoder over TP16_SEQ frames
        out["batch"] = lm_inputs(cfgs["fp32"], out["batch"]["tokens"], gen, TP16_SEQ)
    tokens = torch.randint(0, cfgs["fp32"].vocab, (TP16_SERVE_BATCH, TP16_SERVE_PROMPT),
                           generator=gen, device="cuda")
    out["serve_batch"] = lm_inputs(cfgs["fp32"], tokens, gen, TP16_SEQ)
    for tag, cfg in cfgs.items():
        t0 = time.perf_counter()
        model = init_lm(cfg, seed=0, device="cuda")  # the same weights for both configs
        if "state" in out:
            for k, p in model.named_parameters():
                p.data = out["state"][k]
        out["state"] = {k: p.detach() for k, p in model.named_parameters()}
        records, _, handles = _tp_record_linears(model) if tag == "pallas" else ([], [], [])
        loss, _ = model.loss(out["batch"], TP16_KEY)
        loss.backward()
        for h in handles:
            h.remove()
        ref = {"loss": loss.item()}
        if tag == "fp32":
            ref["grads"] = {k: p.grad for k, p in model.named_parameters()}
        else:
            model.zero_grad(set_to_none=True)
            ref["linears"] = [rec for rec in records if "g" in rec]
            _tp_unsharded_linears(out["state"], ref["linears"])
        del loss
        ref["serve"] = _tp_unsharded_serve(cfg, model, out["serve_batch"],
                                           TP16_SERVE_PROMPT + TP16_SERVE_STEPS + 1,
                                           TP16_SERVE_STEPS, tag)
        ref["seconds"] = time.perf_counter() - t0
        out[tag] = ref
        del model
    torch.cuda.synchronize()
    return out


def _sp16_reference(arch: str) -> dict:
    """One TP16_SP_PATHS path's unsharded references on this process's
    card: the weights (seed 0), the batch, per config the loss and (fp32)
    every gradient or (quantized) each recorded linear call with its
    unsharded y, dx and dw (:func:`_tp_unsharded_linears`)."""
    import torch

    from repro_torch.models.lm import init_lm

    _, tokens, frames, _ = TP16_SP_PATHS[arch]
    cfgs = _tp16_configs(arch, TP16_SP_PATHS)
    batch = next(lm_train_data(cfgs["fp32"], TP16_BATCH, tokens))
    if frames:
        gen = torch.Generator(device="cuda").manual_seed(43)
        batch = lm_inputs(cfgs["fp32"], batch["tokens"], gen, frames)
    out = {"cfgs": cfgs, "shared": TP16_SHARED.get(arch, ()), "batch": batch,
           "seq_shard": True}
    for tag, cfg in cfgs.items():
        t0 = time.perf_counter()
        model = init_lm(cfg, seed=0, device="cuda")
        if "state" in out:
            for k, p in model.named_parameters():
                p.data = out["state"][k]
        out["state"] = {k: p.detach() for k, p in model.named_parameters()}
        records, _, handles = _tp_record_linears(model) if tag == "pallas" else ([], [], [])
        loss = model.loss(batch, TP16_KEY)[0]
        loss.backward()
        for h in handles:
            h.remove()
        ref = {"loss": loss.item(), "seconds": 0.0}
        if tag == "fp32":
            ref["grads"] = {k: p.grad for k, p in model.named_parameters()}
        else:
            ref["linears"] = [rec for rec in records if "g" in rec]
            _tp_unsharded_linears(out["state"], ref["linears"])
        del loss, model, records
        ref["seconds"] = time.perf_counter() - t0
        out[tag] = ref
    torch.cuda.synchronize()
    return out


def _sp16_rank_work(rank: int, ref: dict, tp) -> dict:
    """One rank's sequence-parallel loss and backward of a TP16_SP_PATHS
    path, per config (counts set to 0 just before, read just after), the
    partial gradients summed over the group, held to the unsharded ones
    (fp32: :func:`_tp16_grad_sums`; quantized: each recorded linear call
    run as the SP step ran it, :func:`_tp_linear_checks` with its
    sequence split)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    out = {}
    for tag, cfg in ref["cfgs"].items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = _tp16_model(cfg, ref["state"], ref["shared"], tp, seq_shard=True)
        seqs, handles = _sp_record_seqs(model)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = model.loss(ref["batch"], TP16_KEY)[0]
        loss.backward()
        torch.cuda.synchronize()
        r = dict(step_ms=(time.perf_counter() - t0) * 1e3, launches=launch_counts(),
                 loss=loss.item(), ref_loss=ref[tag]["loss"], split=dict(model.seq_split),
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
        for h in handles:
            h.remove()
        del loss
        _sp_grads(model)  # in place: p.grad whole where it was partial
        if tag == "fp32":
            r["grads"] = _tp16_grad_sums(model, ref["fp32"]["grads"], rank)
        else:
            model.zero_grad(set_to_none=True)
            recs = ref["pallas"]["linears"]
            r["linears"] = _tp_linear_checks(ref["state"], recs, model.tp_layout, tp,
                                             [seqs[rec["name"]][rec["call"]] for rec in recs])
        out[tag] = r
        del model
    return out


def _tp16_model(cfg, state: dict, shared: tuple, tp, seq_shard: bool = False):
    """This rank's tensor-parallel model of ``cfg`` (``seq_shard``: with
    sequence parallelism), made on the meta device and given its shards of
    the unsharded ``state`` on the card; the ``shared`` parameters are
    ``state``'s own tensors (one copy on the card), frozen."""
    import torch

    from repro_torch.models.lm import LM
    from repro_torch.parallel.tensor import tensor_parallel

    with torch.device("meta"):
        model = tensor_parallel(LM(cfg), tp, seq_shard=seq_shard)
    layout = model.tp_layout
    with torch.no_grad():
        for k, _ in list(model.named_parameters()):
            owner, _, attr = k.rpartition(".")
            if k in shared:
                t = state[k]
            else:
                t = layout[k].take(state[k], tp.rank) if k in layout else state[k]
                t = t.clone(memory_format=torch.contiguous_format)
            setattr(model.get_submodule(owner), attr,
                    torch.nn.Parameter(t, requires_grad=k not in shared))
    return model


def _tp16_grad_sums(model, grads: dict, rank: int) -> dict:
    """This rank's gradients against the unsharded ones (their slices),
    as sums of squares by split (a sharded parameter's part of the whole
    gradient) and whole (replicated: counted once, from one rank): the
    difference, the reference and the rank's own, and the worst tensor."""
    sums = {f"{kind}_{what}": 0.0 for kind in ("split", "whole")
            for what in ("diff", "want", "got")}
    worst = (0.0, None)
    for k, p in model.named_parameters():
        if p.grad is None:  # frozen
            continue
        split = model.tp_layout.get(k)
        want = grads[k] if split is None else split.take(grads[k], rank)
        kind = "whole" if split is None else "split"
        diff = float((p.grad.double() - want.double()).square().sum())
        sq = float(want.double().square().sum())
        sums[f"{kind}_diff"] += diff
        sums[f"{kind}_want"] += sq
        sums[f"{kind}_got"] += float(p.grad.double().square().sum())
        worst = max(worst, ((diff / max(sq, 1e-60)) ** 0.5, k), key=lambda v: v[0])
    return dict(sums, worst=worst)


def _tp16_rank_work(rank: int, refs: dict) -> dict:
    """One rank of the 16, on one path's references ``refs`` (``{arch:
    ...}``, :func:`_tp16_reference`): for each config, its model
    (:func:`_tp16_model`), the loss and backward (counts set to 0 just
    before, read just after) against the unsharded references (fp32: the
    gradients' sums of squares; quantized: each recorded linear by this
    rank's tensor-parallel linear), then the same model served,
    teacher-forced on the unsharded engine's tokens (:func:`_tp_serve_case`)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel.tensor import TensorParallel

    tp = TensorParallel.of()
    out = {}
    for arch, ref in refs.items():
        if ref.get("seq_shard"):
            out[arch] = _sp16_rank_work(rank, ref, tp)
            continue
        out[arch] = {}
        for tag, cfg in ref["cfgs"].items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = _tp16_model(cfg, ref["state"], ref["shared"], tp)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, _ = model.loss(ref["batch"], TP16_KEY)
            loss.backward()
            torch.cuda.synchronize()
            r = dict(step_ms=(time.perf_counter() - t0) * 1e3, build_s=build_s,
                     launches=launch_counts(),
                     loss=loss.item(), ref_loss=ref[tag]["loss"],
                     peak_memory_bytes=torch.cuda.max_memory_allocated(),
                     card_used_bytes=torch.cuda.mem_get_info()[1] - torch.cuda.mem_get_info()[0])
            del loss
            if tag == "fp32":
                r["grads"] = _tp16_grad_sums(model, ref["fp32"]["grads"], rank)
            model.zero_grad(set_to_none=True)
            t0 = time.perf_counter()
            if tag == "pallas":
                r["linears"] = _tp_linear_checks(ref["state"], ref["pallas"]["linears"],
                                                 model.tp_layout, tp)
            r["checks_s"], t0 = time.perf_counter() - t0, time.perf_counter()
            r["serve"] = _tp_serve_case(cfg, model, ref["serve_batch"], ref[tag]["serve"],
                                        TP16_SERVE_PROMPT + TP16_SERVE_STEPS + 1, tag)
            r["serve_s"] = time.perf_counter() - t0
            out[arch][tag] = r
            del model
    return out


def _tp16_rank(rank: int, world: int, port: int, out: str, jobs: list, done) -> None:
    """One rank of the 16-rank model axis on cuda:0 over gloo: each path's
    references from ``jobs[rank]`` in turn (None: the end), released
    before the rank reports the path ``done``; its results saved at the
    end."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.runtime import resolve_device

    torch.cuda.set_device(0)
    resolve_device("cuda")  # TF32 off
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    results = {"rank": rank, "ready": time.time()}
    try:
        while (refs := jobs[rank].get()) is not None:
            results.update(_tp16_rank_work(rank, refs))
            refs.clear()  # release the shared tensors, then report the path done
            del refs
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            done.put(rank)
        torch.save(results, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def tensor16(smi: str, bad: list) -> dict:
    """The model axis of 16 (TP16_PATHS): the 16 ranks spawned once; a
    path at a time, its unsharded references run here and handed to every
    rank, released once every rank reports the path done (one path's
    references on the card at a time); then each rank held: fp32 loss, grad
    norm and gradients (one vector, relative L2) within TP_AGREE["fp32"] of
    the unsharded ones; the quantized loss within TP_AGREE["pallas"]; each
    quantized linear call's slices bit for bit and its sums within their
    bound, every linear whole on every rank the unsharded one bit for
    bit; serving every step's logits within TP_SERVE_AGREE (quantized:
    fed), the greedy tokens equal on all 16 ranks; and the launches of
    ranks TP16_HELD the closed forms (lm_train_launches, serve_launches at
    a model axis of 16).  Appends what fails to ``bad``; returns the
    record (timings, launches of rank 0)."""
    import queue
    import tempfile

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    jobs, done = [ctx.SimpleQueue() for _ in range(TP16_AXIS)], ctx.Queue()
    rec = dict(model_axis=TP16_AXIS, batch=TP16_BATCH, reference_s={}, launches={}, paths={})
    n_linears = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "tp16")
        spawned, t1 = time.time(), time.perf_counter()
        world = mp.start_processes(_tp16_rank, args=(TP16_AXIS, _free_port(), out, jobs, done),
                                   nprocs=TP16_AXIS, join=False, start_method="spawn")
        try:
            paths = [*TP16_PATHS, *(f"{a} sp" for a in TP16_SP_PATHS)]
            for arch in paths:  # a path at a time: one path's references on the card
                t0 = time.perf_counter()
                sp = arch.endswith(" sp")
                refs = {arch: _sp16_reference(arch[:-3]) if sp else _tp16_reference(arch)}
                rec["reference_s"][arch] = time.perf_counter() - t0
                if not sp:
                    n_linears[arch] = len(refs[arch]["pallas"]["linears"])
                for q in jobs:
                    q.put(refs)
                finished = 0
                while finished < TP16_AXIS:
                    try:
                        done.get(timeout=5)
                        finished += 1
                    except queue.Empty:
                        world.join(timeout=0)  # raises where a rank failed
                del refs
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
            for q in jobs:
                q.put(None)
            while not world.join():
                pass
        finally:
            for proc in world.processes:
                if proc.is_alive():
                    proc.terminate()
        rec["spawn_s"] = time.perf_counter() - t1
        ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(TP16_AXIS)]
    rec["startup_s"] = max(r["ready"] for r in ranks) - spawned
    print(f"tensor model 16 ({smi}): {TP16_AXIS} ranks on cuda:0 over gloo "
          f"{rec['spawn_s']:.1f} s, of which startup (spawn to the last rank's process "
          f"group) {rec['startup_s']:.1f} s; unsharded references "
          f"{ {a: round(t, 1) for a, t in rec['reference_s'].items()} } s")
    for arch in TP16_PATHS:
        cfgs = _tp16_configs(arch)
        path = rec["paths"][arch] = dict(cut=TP16_PATHS[arch][2])
        for tag in ("fp32", "pallas"):
            rs = [r[arch][tag] for r in ranks]
            gaps = [abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"]) for r in rs]
            tol = TP_AGREE[tag]
            if not all(math.isfinite(r["loss"]) for r in rs) or max(gaps) > tol:
                bad.append(f"model 16 {arch} {tag}: loss gaps {gaps}")
            row = dict(loss_gap=max(gaps), step_ms=[r["step_ms"] for r in rs],
                       seconds={k: max(r[k] for r in rs) for k in ("build_s", "checks_s",
                                                                    "serve_s")},
                       peak_memory_bytes=max(r["peak_memory_bytes"] for r in rs),
                       card_used_bytes=max(r["card_used_bytes"] for r in rs))
            if tag == "fp32":
                g = [r["grads"] for r in rs]
                diff = sum(x["split_diff"] for x in g) + g[0]["whole_diff"]
                want = sum(x["split_want"] for x in g) + g[0]["whole_want"]
                got = sum(x["split_got"] for x in g) + g[0]["whole_got"]
                whole = [(x["whole_diff"] / max(x["whole_want"], 1e-60)) ** 0.5 for x in g]
                row.update(grads_rel=math.sqrt(diff / want),
                           grad_norm_rel=abs(math.sqrt(got) - math.sqrt(want)) / math.sqrt(want),
                           whole_grads_rel=max(whole), worst=max(x["worst"] for x in g))
                for what in ("grads_rel", "grad_norm_rel", "whole_grads_rel"):
                    if row[what] > tol:
                        bad.append(f"model 16 {arch} fp32 {what} {row[what]}")
            else:
                lin = [c for r in rs for c in r["linears"]]
                wrong = [c for c in lin if not c["ok"]]
                n = n_linears[arch]
                row.update(linears=len(lin),
                           linears_whole=sum(c["kind"] == "whole" for c in lin),
                           linears_worst=max(c["sum_err"] / max(c["sum_tol"], 1e-30)
                                             for c in lin))
                if wrong or n != tp_linears(cfgs["pallas"]) or len(lin) != n * TP16_AXIS:
                    bad.append(f"model 16 {arch} linears {wrong[:3]} ({len(lin)} of {n} x 16)")
                want = lm_train_launches(cfgs["pallas"], model_axis=TP16_AXIS)
                for i in TP16_HELD:
                    got = {k: rs[i]["launches"].get(k, 0) for k in want}
                    if got != want:
                        bad.append(f"model 16 {arch} rank {i} launches {got}, expected {want}")
                row["expected_launches"] = want
                rec["launches"][arch] = rs[0]["launches"]
            s = [r["serve"] for r in rs]
            held = [max(x["gap"] if tag == "fp32" else x["fed_gap"]) for x in s]
            row.update(serve_gap=max(held), serve_unfed_gap=max(max(x["gap"]) for x in s),
                       greedy_equal=min(x["greedy_equal"] for x in s),
                       prefill_ms=[x["prefill_ms"] for x in s],
                       decode_ms=[statistics.median(x["decode_ms"]) for x in s])
            if not all(x["finite"] for x in s) or max(held) > TP_SERVE_AGREE:
                bad.append(f"model 16 serve {arch} {tag}: logits gaps {held}")
            if any(x["tokens"] != s[0]["tokens"] for x in s):
                bad.append(f"model 16 serve {arch} {tag}: the ranks' tokens differ")
            if tag == "pallas":
                rows = [x["fed_rows"] for x in s]
                row["fed_rows_worst"] = max(x["worst"] for x in rows)
                if any(x["bad"] or not x["calls"] for x in rows):
                    bad.append(f"model 16 serve {arch}: row-parallel outputs off the unsharded "
                               f"ones {[x['bad'][:2] for x in rows][:3]}")
                want = [serve_launches(cfgs["pallas"], model_axis=TP16_AXIS, prefill=True)] + [
                    serve_launches(cfgs["pallas"], model_axis=TP16_AXIS)] * TP16_SERVE_STEPS
                want = [{k: n for k, n in w.items() if n} for w in want]
                for i in TP16_HELD:
                    if s[i]["step_launches"] != want:
                        bad.append(f"model 16 serve {arch} rank {i} launches per step "
                                   f"{s[i]['step_launches']}, expected {want}")
                rec["launches"][f"{arch} serve"] = s[0]["launches"]
            elif any(x["launches"] for x in s):
                bad.append(f"model 16 serve {arch} fp32 launched {s[0]['launches']}")
            path[tag] = row
            print(f"tensor model 16 {arch} {tag} ({smi}; gloo through the host on one card: "
                  f"not a TP speed): loss gap {row['loss_gap']:.3g}"
                  + (f", gradients {row['grads_rel']:.3g} (whole ones "
                     f"{row['whole_grads_rel']:.3g}, grad norm {row['grad_norm_rel']:.3g})"
                     if tag == "fp32" else
                     f", {row['linears']} linear calls checked ({row['linears_whole']} whole), "
                     f"worst sum {row['linears_worst']:.3g} of its bound")
                  + f"; step ms rank 0 / {TP16_AXIS - 1} {row['step_ms'][0]:.1f} / "
                  f"{row['step_ms'][-1]:.1f}; "
                  f"peak {row['peak_memory_bytes'] / 2**30:.2f} GiB a rank, card "
                  f"{row['card_used_bytes'] / 2**30:.1f} GiB used; serving gap "
                  f"{row['serve_gap']:.3g} (unfed {row['serve_unfed_gap']:.3g}), greedy "
                  f"{row['greedy_equal']:.3f}, prefill {row['prefill_ms'][0]:.1f} ms, decode "
                  f"{row['decode_ms'][0]:.2f} ms/step; seconds (slowest rank) "
                  f"{ {k: round(v, 1) for k, v in row['seconds'].items()} }")
    for arch in TP16_SP_PATHS:
        rec["paths"][f"{arch} sp"] = _sp16_checks(arch, [r[f"{arch} sp"] for r in ranks], smi,
                                                  bad, rec["launches"])
    return rec


def _sp16_checks(arch: str, rs: list, smi: str, bad: list, launches: dict) -> dict:
    """A TP16_SP_PATHS path's 16 ranks held (see there); rank 0's quantized
    launches go to ``launches`` as "<arch> sp"."""
    from repro_torch.parallel.tensor import attention_heads

    cut, path = TP16_SP_PATHS[arch][3], {}
    for tag in ("fp32", "pallas"):
        cfg = _tp16_configs(arch, TP16_SP_PATHS)[tag]
        t = [r[tag] for r in rs]
        gaps = [abs(x["loss"] - x["ref_loss"]) / abs(x["ref_loss"]) for x in t]
        row = dict(loss_gap=max(gaps), split=t[0]["split"], step_ms=[x["step_ms"] for x in t],
                   peak_memory_bytes=max(x["peak_memory_bytes"] for x in t))
        if not all(math.isfinite(x["loss"]) for x in t) or max(gaps) > SP_AGREE[tag]:
            bad.append(f"model 16 sp {arch} {tag}: loss gaps {gaps}")
        if any(x["split"] != t[0]["split"] for x in t) or not t[0]["split"]["dec"]:
            bad.append(f"model 16 sp {arch} {tag}: sequences split {[x['split'] for x in t]}")
        if tag == "fp32":
            g = [x["grads"] for x in t]
            diff = sum(x["split_diff"] for x in g) + g[0]["whole_diff"]
            want = sum(x["split_want"] for x in g) + g[0]["whole_want"]
            got = sum(x["split_got"] for x in g) + g[0]["whole_got"]
            whole = [(x["whole_diff"] / max(x["whole_want"], 1e-60)) ** 0.5 for x in g]
            row.update(grads_rel=math.sqrt(diff / want),
                       grad_norm_rel=abs(math.sqrt(got) - math.sqrt(want)) / math.sqrt(want),
                       whole_grads_rel=max(whole), worst=max(x["worst"] for x in g))
            for what in ("grads_rel", "grad_norm_rel", "whole_grads_rel"):
                if row[what] > TP_AGREE["fp32"]:
                    bad.append(f"model 16 sp {arch} fp32 {what} {row[what]}")
        else:
            lin = [c for x in t for c in x["linears"]]
            wrong = [c for c in lin if not c["ok"]]
            tokens = sum(c["kind"] == "tokens" for c in t[0]["linears"])
            row.update(linears=len(lin), linears_tokens=tokens,
                       linears_worst=max((c["sum_err"] / max(c["sum_tol"], 1e-30) for c in lin),
                                         default=0.0))
            # a whole attention runs its linears on the rank's tokens: they must be fed
            whole_attn = bool(cfg.n_heads) and attention_heads(cfg, TP16_AXIS) is None
            if (wrong or not lin or len(lin) != len(t[0]["linears"]) * TP16_AXIS
                    or bool(tokens) != whole_attn):
                bad.append(f"model 16 sp {arch}: linears {wrong[:3]} of {len(lin)} "
                           f"({tokens} on the rank's tokens a rank)")
            split = (t[0]["split"]["dec"], t[0]["split"]["enc"])
            want = lm_train_launches(cfg, model_axis=TP16_AXIS, seq_split=split)
            for i in TP16_HELD:
                got = {k: t[i]["launches"].get(k, 0) for k in want}
                if got != want:
                    bad.append(f"model 16 sp {arch} rank {i} launches {got}, expected {want}")
            row["expected_launches"] = want
            launches[f"{arch} sp"] = t[0]["launches"]
        path[tag] = row
        print(f"tensor model 16 sp {arch} {tag} ({smi}; gloo through the host on one card: not "
              f"an SP speed): {cut}; sequences split {row['split']}; loss gap "
              f"{row['loss_gap']:.3g}"
              + (f", gradients {row['grads_rel']:.3g} (whole ones {row['whole_grads_rel']:.3g}, "
                 f"grad norm {row['grad_norm_rel']:.3g})" if tag == "fp32" else
                 f", {row['linears']} linear calls fed ({row['linears_tokens']} a rank on its "
                 f"tokens), worst sum {row['linears_worst']:.3g} of its bound")
              + f"; loss+backward ms rank 0 / {TP16_AXIS - 1} {row['step_ms'][0]:.1f} / "
              f"{row['step_ms'][-1]:.1f}; peak {row['peak_memory_bytes'] / 2**30:.2f} GiB a rank")
    return path


WGMMA_REPORTED = "lm_train chatglm3-6b w_up fwd "  # K3's wgmma row on the kernels line


def wgmma_summary(results: dict) -> dict | None:
    """K3's wgmma variant at chatglm3-6b's w_up forward (8192 x 4096 x
    13696) from the lm_train phase's timed rows: ms and kernel ms beside
    the walk's, the int8-op bound and torch._int_mm (the int8 dot alone,
    not K3's function); and its launches in each model's lm_train run."""
    lm = results.get("lm_train", {})
    row = next((r for r in lm.get("kernel_times", []) if r["name"] == "mls_matmul"
                and r["shape"].startswith(WGMMA_REPORTED)), None)
    if row is None:
        return None
    return dict(shape=row["shape"], ms=row["ms"], kernel_ms=row["kernel_ms"],
                walk_ms=row.get("plans_ms", {}).get("walk"),
                walk_kernel_ms=row.get("plans_kernel_ms", {}).get("walk"),
                int_mm_ms=row.get("int_mm_ms"), bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], plain_ms=row["plain_ms"],
                max_abs_err=row["max_abs_err"],
                lm_train_launches={m: r.get("k3_variants", {}).get("wgmma", 0)
                                   for m, r in lm.get("models", {}).items()})


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside {Path(__file__).name}")
    from repro_torch.kernels import build
    from repro_torch.runtime import resolve_device
    from repro_torch.sweep.record import nvidia_smi

    smi_line = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line}")

    resolve_device("cuda")  # TF32 off
    results: dict = {"nvidia_smi": smi_line, "torch": torch.__version__,
                     "cuda": torch.version.cuda}
    failures = []
    t0 = time.perf_counter()
    try:
        build.library()
        results["build_s"] = time.perf_counter() - t0
        print(f"build: {results['build_s']:.1f} s ({build.library_path().name})")
        log = build.library_path().with_suffix(".log")
        if log.exists():  # each kernel's registers and spills, under its (mangled) name
            results["ptxas"], fn = [], ""
            for ln in log.read_text().splitlines():
                if "Function properties for " in ln:
                    fn = ln.split("Function properties for ")[1].strip()
                elif "registers" in ln or "spill" in ln:
                    results["ptxas"].append(f"{fn}: {ln.strip()}")
    except Exception:
        traceback.print_exc()
        fail("kernel build failed")

    rows, launches, serve_launches, lm_train_launches_, sweep_launches = [], {}, {}, {}, {}
    parallel_launches: dict = {}
    tensor_launches: dict = {}
    for name, phase in (("kernels", phase_kernels), ("tune", phase_tune), ("train", phase_train),
                        ("trace", phase_trace), ("agree", phase_agree),
                        ("audit", phase_audit), ("zoo", phase_zoo),
                        ("fake_quant", phase_fakequant), ("driver", phase_driver),
                        ("serve", phase_serve), ("lm_train", phase_lm_train),
                        ("dryrun", phase_dryrun), ("sweep", phase_sweep),
                        ("parallel", phase_parallel), ("tensor", phase_tensor)):
        t = time.perf_counter()
        try:
            out = phase(results)
            if name == "kernels":
                rows = out
            elif name == "train":
                launches = out
            elif name == "audit":
                rows.append(out[0])
                launches["sabotage_overlap"] = out[1]
            elif name == "serve":
                serve_launches = out
            elif name == "lm_train":
                lm_train_launches_ = out
            elif name == "sweep":
                sweep_launches = out
            elif name == "parallel":
                parallel_launches = out
            elif name == "tensor":
                tensor_launches, tensor_rows = out
                rows += tensor_rows
                # the split entries' path is the tensor phase's (per rank, both paths)
                launches.update({k: sum(n.get(k, 0) for n in tensor_launches.values())
                                 for k in TP_ENTRIES})
        except Exception:
            traceback.print_exc()
            failures.append(name)
        results[f"{name}_s"] = time.perf_counter() - t
        print(f"phase {name}: {'FAILED' if name in failures else 'ok'} "
              f"({results[f'{name}_s']:.1f} s)")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    if failures:
        fail(f"phases failed: {failures}")
    kernels = []
    for r in rows:  # the first row timed at each kernel's reported shape
        if (not r["shape"].startswith(REPORTED_SHAPE[r["name"]])
                or any(k["name"] == r["name"] for k in kernels)):
            continue
        source, replaces = KERNELS[r["name"]]
        kernels.append(dict(name=r["name"], route="cuda", source=source, replaces=replaces,
                            launches=launches.get(r["name"], 0),
                            serve_launches={m: n.get(r["name"], 0)
                                            for m, n in serve_launches.items()},
                            lm_train_launches={m: n.get(r["name"], 0)
                                               for m, n in lm_train_launches_.items()},
                            sweep_launches={c: n.get(r["name"], 0)
                                            for c, n in sweep_launches.items()},
                            parallel_launches=parallel_launches.get(r["name"], 0),
                            wire_launches=sum(n.get(r["name"], 0) for n in results.get(
                                "parallel", {}).get("wire", {}).get("launches", [])),
                            tensor_launches={a: n.get(r["name"], 0)
                                             for a, n in tensor_launches.items()},
                            max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
                            shape=r["shape"],
                            **{k: r[k] for k in ("im2col_ms", "kernel_ms") if k in r}))
    for k in kernels:  # K3's wgmma variant, where the LM training path runs it
        if k["name"] == "mls_matmul":
            k["wgmma"] = wgmma_summary(results)
    missing = [k for k in KERNELS if not any(r["name"] == k for r in kernels)]
    if missing or any(launches.get(k, 0) == 0 for k in KERNELS):
        fail(f"kernels not timed or not launched by their path: {missing} {launches}")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
