"""Configuration dataclasses of the port.

The port's own copy of ``active_inference_diffusion_tpu/configs/config.py``:
the same dataclasses with the same fields, defaults and ``__post_init__``
checks, and the same YAML loader, so a config file of the JAX package loads
here unchanged (``tests/test_torch_config.py`` holds the two against each
other). ``TpuConfig`` keeps its name: ``compute_dtype`` and
``denoiser_kernel`` select the sweep kernel on the card as on the TPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class DiffusionConfig:
    """Diffusion process configuration (reference: configs/config.py:10-22)."""

    num_diffusion_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "cosine"  # "cosine" | "linear"
    # Validated reference-schema fields: only score prediction and the
    # continuous-time score-matching objective are implemented — exactly the
    # branches the reference takes (its own config declares these knobs but
    # never reads them anywhere: zero uses outside configs/config.py in the
    # reference tree). Setting them off fails loudly instead of silently.
    prediction_type: str = "score"
    use_continuous_time: bool = True
    # Reference-schema compatibility, inert THERE TOO (zero reads outside its
    # configs/config.py): the actual loss-weight anneal is the log-SNR +
    # sin(pi t) weight of reference core/diffusion.py:93-104, implemented in
    # core/diffusion.compute_loss_weight; the actual clip is
    # ActiveInferenceConfig.gradient_clip.
    time_annealing_start: float = 1.0
    time_annealing_end: float = 0.1
    annealing_steps: int = 100_000
    gradient_clip_val: float = 0.1

    def __post_init__(self):
        if self.prediction_type != "score":
            raise ValueError(
                f"prediction_type={self.prediction_type!r}: only 'score' is "
                "implemented (the reference also only ever computes score "
                "targets; its config knob is decorative)"
            )
        if not self.use_continuous_time:
            raise ValueError(
                "use_continuous_time=False: only the continuous-time "
                "score-matching objective is implemented (the only branch "
                "the reference ever takes; discrete q_sample/p_sample serve "
                "the belief sweep, not the training objective)"
            )


@dataclass
class BeliefDynamicsConfig:
    """Fokker-Planck belief dynamics configuration (reference: configs/config.py:24-35).

    The reference declares ``use_belief_dynamics: True`` but never reads it
    anywhere (its BeliefDynamics is constructed by no agent and its update()
    is uncallable, reference core/belief_dynamics.py:170 vs :344). Here the
    flag is REAL: when set, acting refines each belief latent with
    ``refine_steps`` Fokker-Planck mean-drift steps on -grad F of the decoder
    likelihood (core/belief_dynamics.fp_refine_mean, wired in
    DiffusionActiveInference.act/act_planned/act_warm). Default False — the
    reference's True was inert, and defaulting an extra act-time refinement
    on would silently change every tuned preset (see DEVIATIONS.md).
    """

    use_belief_dynamics: bool = False
    # Number of FP mean-refinement steps applied to the belief latent at act
    # time when use_belief_dynamics is set (extension field; the reference has
    # no step-count knob because nothing consumed its dynamics).
    refine_steps: int = 1
    # Reference-schema compat, inert there too: the refinement operates on
    # the agent's latent belief, whose dimension is
    # ActiveInferenceConfig.latent_dim (the reference's standalone
    # BeliefDynamics took its own dim because no agent ever constructed it).
    belief_dim: int = 50
    diffusion_coefficient: float = 0.1
    learning_rate: float = 0.1
    dt: float = 0.01
    min_variance: float = 1e-6
    max_variance: float = 10.0
    use_full_covariance: bool = False
    noise_scale: float = 0.01


@dataclass
class SemanticsConfig:
    """Flags selecting corrected vs reference-faithful semantics.

    The reference has several quirks (see DEVIATIONS.md). ``corrected`` (default)
    implements the evidently intended behavior; ``faithful`` replicates the
    reference's literal computation.

    - ``pragmatic_sign``: the reference ADDS the pragmatic (reward + value) term to
      the minimized EFE (reference: core/active_inference.py:369-375), so the policy
      is trained to minimize expected reward. corrected uses -1 (seek reward).
    - ``double_pragmatic_weight``: the reference applies ``pragmatic_weight`` twice
      (core/active_inference.py:353 and :371).
    - ``train_decoder_and_reward``: the reference's optimizer zero_grad ordering
      wipes decoder/reward-predictor gradients before their step, so they are
      never trained (agents/state_agent.py:225 after :151). corrected trains them.
    - ``deterministic_eval``: the reference evaluates with a stochastic policy
      (utils/training.py:47).
    - ``epistemic_sign``: the reference ADDS the epistemic (information-gain)
      term to the minimized EFE (reference core/active_inference.py:383-388),
      so comparing EFE values would AVOID informative actions. Inert in the
      reference (the EFE is never used for selection, :501-510) but
      behavior-affecting in ``act_planned``; corrected uses -1 (info-seeking,
      the canonical p(a) ∝ exp(-G) rule).
    - ``pixel_recon_target_stopgrad``: the reference's pixel ELBO uses the
      live encoder features as the reconstruction TARGET with encoder
      gradients flowing through the target (reference pixel_agent.py:291-292,
      317-333) — the encoder is then rewarded for collapsing to constant
      features (recon -> 0 trivially, InfoNCE pinned at chance = ln batch;
      observed empirically at the reference pixel config). corrected
      stop-gradients the target: the decoder still learns to reconstruct
      features, while encoder gradients arrive only through score-network
      conditioning and the contrastive loss.
    """

    mode: str = "corrected"  # "corrected" | "faithful"

    # The reference's continuous-time score-matching target is
    # -eps / sigma, dividing by the VARIANCE, not the true score
    # -eps / sqrt(sigma) (reference core/active_inference.py:594-595;
    # continuous_q_sample defines z_t = sqrt(alpha) z0 + sqrt(sigma) eps, so
    # grad_z log q(z_t|z0) = -eps/sqrt(sigma)). The mis-scaling CO-ADAPTS
    # with the rest of the system (the reverse sweep consumes the same
    # network the objective trains), so rounds 1-3 kept the reference
    # scaling as the corrected-mode default pending preset-scale evidence.
    # That evidence now exists twice — HalfCheetahPlanar fused (row-11 A/B,
    # commit 656fb3c: preset pace) and Walker2dPlanar fused (round 4:
    # stable climb to ~480 at 512k on the constraint engine,
    # docs/runs/fused_Walker2dPlanar_std.jsonl) — so corrected mode now
    # DEFAULTS to the true score ("standard"); set "reference" to reproduce
    # the historical runs. Faithful mode always uses the reference scaling.
    # See DEVIATIONS.md row 11.
    score_target_convention: Optional[str] = None  # None|"reference"|"standard"

    def __post_init__(self):
        if self.mode not in ("corrected", "faithful"):
            raise ValueError(f"Unknown semantics mode {self.mode!r}")
        if self.score_target_convention not in (None, "reference", "standard"):
            raise ValueError(
                "score_target_convention must be None, 'reference', or "
                f"'standard'; got {self.score_target_convention!r}"
            )
        if self.mode == "faithful" and self.score_target_convention == "standard":
            raise ValueError(
                "faithful mode replicates the reference's literal math; it "
                "cannot use the standard score-target convention"
            )

    @property
    def score_target_uses_std(self) -> bool:
        """True -> train toward the true score -eps/std; False -> the
        reference's -eps/variance."""
        if self.mode == "faithful":
            return False
        return (self.score_target_convention or "standard") == "standard"

    @property
    def pragmatic_sign(self) -> float:
        return 1.0 if self.mode == "faithful" else -1.0

    @property
    def epistemic_sign(self) -> float:
        return 1.0 if self.mode == "faithful" else -1.0

    @property
    def double_pragmatic_weight(self) -> bool:
        return self.mode == "faithful"

    @property
    def train_decoder_and_reward(self) -> bool:
        return self.mode != "faithful"

    @property
    def deterministic_eval(self) -> bool:
        return self.mode != "faithful"

    @property
    def pixel_recon_target_stopgrad(self) -> bool:
        return self.mode != "faithful"


@dataclass
class TpuConfig:
    """TPU execution configuration (new; no reference equivalent)."""

    # "float32" | "bfloat16": storage dtype of the matmul kernels inside the
    # fused Pallas denoiser. On real TPUs this changes NOTHING numerically —
    # Mosaic already lowers f32 dots to single bf16 MXU passes at default
    # precision (verified: f32-vs-bf16 kernel outputs are bit-identical on
    # v5e) — its benefit is halving the VMEM weight footprint, which extends
    # the fused kernel to larger hidden dims. Interpret mode (CPU tests)
    # does show bf16 rounding.
    compute_dtype: str = "float32"
    # Fused Pallas K-step denoiser (ops/denoise.py). Safe to enable: the
    # runtime gate (DiffusionActiveInference._use_fused_sweep) only engages it
    # on a TPU backend when the trunk weights fit the VMEM budget, and belief
    # sweeps are always consumed under stop_gradient (the ELBO differentiates
    # single score-net applications, never the sweep). Default off: interleaved
    # A/B on v5e at the flagship config (batch 256, hidden 128, K=25) measures
    # the XLA scan at ~0.9-1.0x the kernel's latency — XLA already keeps this
    # sweep compute-bound — so the kernel is an opt-in for configs where
    # weight re-streaming dominates; bench.py measures both and reports the
    # faster.
    use_pallas_denoiser: bool = False
    # Kernel variant for the fused denoiser. "v1" (default): one matmul per
    # site. "v2": fuses the seq-len-1 attention pair v_proj@out_proj into
    # one precomputed matmul and batches all 2L+1 z-independent adaLN
    # modulation products into ONE wide matmul per step (~22 vs ~40
    # matmuls/step). v2 was built for the latency-bound flagship regime
    # (VERDICT r4 #8) and MEASURED SLOWER on v5e: 0.83x v1 at both flagship
    # (397 vs 480 sweeps/s) and humanoid scale (369 vs 444), 2026-08-21
    # bench_r5a — inside a single Pallas kernel there is no per-matmul
    # dispatch cost to save, so fewer/larger matmuls only lengthen the
    # critical path. Kept as a tested negative result; the latency floor at
    # these model sizes is the K sequential trunk applications themselves
    # (three implementations — XLA scan, v1, v2 — land within ±15%).
    denoiser_kernel: str = "v1"
    donate_buffers: bool = True
    remat_score_network: bool = False  # jax.checkpoint the score net in the ELBO


@dataclass
class ActiveInferenceConfig:
    """Main agent configuration (reference: configs/config.py:37-86)."""

    # Environment
    env_name: str = "HalfCheetah-v4"
    observation_dim: int = 17
    action_dim: int = 6

    # Active inference parameters
    # Sensory-precision init for the standalone free-energy component
    # (core/free_energy, consumed by
    # DiffusionActiveInference.init_free_energy_state — the reference's only
    # real consumer of this field, reference core/free_energy.py:20-24).
    precision_init: float = 1.0
    # Reference-schema alias of efe_horizon (the reference declares it and
    # reads neither, hardcoding horizon=5; __post_init__ folds a non-default
    # value into efe_horizon so setting EITHER name works).
    expected_free_energy_horizon: int = 5
    efe_horizon: int = 5
    num_efe_trajectories: int = 10
    num_ambiguity_samples: int = 10
    epistemic_weight: float = 0.1
    # Reference-schema alias of pragmatic_weight (same treatment as
    # expected_free_energy_horizon above).
    extrinsic_weight: float = 1.0
    pragmatic_weight: float = 1.0
    consistency_weight: float = 0.1
    # Weight of the value-bootstrap term inside the EFE pragmatic component
    # (1.0 = the reference's behavior, core/active_inference.py:355-357;
    # 0.0 = pure predicted-reward pragmatics).
    efe_value_weight: float = 1.0
    discount_factor: float = 0.99
    # EFE-based action selection (active-inference decision rule; the
    # reference computes EFE in act() but never uses it — reference
    # core/active_inference.py:501-510). 0 disables (policy sample, the
    # reference path); C > 0 scores C candidate actions by G(a, pi) and picks
    # argmin (plan_temperature == 0) or samples softmax(-G/T) over candidates.
    plan_candidates: int = 0
    plan_temperature: float = 0.0
    contrastive_weight: float = 0.5
    # SPR-style latent forward-prediction regression (pixel agents):
    # || dynamics(z_t, a_t) - sg(z_{t+1}) ||^2 with gradients flowing into
    # the encoder/posterior through z_t. This is the temporal representation
    # pressure the round-5 probe showed was missing: the main dynamics loss
    # stop-gradients BOTH sides (state_agent.py fused loss), and InfoNCE at
    # temperature 0.1 with batch negatives is winnable on position alone, so
    # nothing forced velocity (theta_dot R^2 0.22 ~= random-init 0.18,
    # docs/runs/pixel_probe_r5.json) into the acting latent. Regression to
    # the next latent is NOT satisfiable without velocity: predicting
    # theta_{t+1} requires theta_dot_t. 0 disables (pre-round-5 behavior).
    latent_forward_weight: float = 0.0
    lambda_return: float = 0.95
    lambda_n_steps: int = 5

    # Diffusion integration
    kl_weight: float = 0.1
    diffusion_weight: float = 1.0
    reward_weight: float = 0.5
    grad_penalty_weight: float = 0.1

    # Model architecture
    hidden_dim: int = 512
    latent_dim: int = 128
    spatial_aggregator_output_dim: int = 256
    num_layers: int = 3
    score_num_layers: int = 6
    pixel_observation: bool = False
    # Spectral normalization of the pixel encoder/decoder convs (reference
    # wraps convs in nn.utils.spectral_norm, encoder/visual_encoders.py:70-71,
    # default True there). Implemented statelessly (power iteration from a
    # fixed start vector each forward, models/encoders.spectral_normalize) so
    # no mutable u/v buffers thread through the params pytree. Default False
    # (deviation from the reference's default-on; documented in DEVIATIONS.md).
    use_spectral_norm: bool = False

    # Tanh-squash the policy (None -> resolved from semantics mode:
    # corrected=True, faithful=False). The reference's unsquashed head
    # (policy_networks.py:30 squash_output=False) is only survivable because
    # its sign bug MINIMIZES reward — actually maximizing a learned reward
    # predictor with an unbounded Gaussian mean collapses to constant
    # saturated actions (observed: eval pinned at -600 +- 2 on HalfCheetah).
    policy_squash: Optional[bool] = None

    # Differentiable belief sweep ("grounded beliefs", experimental; no
    # reference counterpart). The reference generates belief latents under
    # no_grad (agents/state_agent.py:134-140), so reconstruction/reward
    # gradients reach only the decoder — nothing ever forces the belief to
    # encode the observation. With this flag the reverse-diffusion sweep is
    # differentiated end-to-end (the noise is explicit, so the sweep is
    # reparameterizable) and reconstruction + reward + KL gradients flow into
    # the score network; the score-matching target still uses stop-gradient
    # latents as z_0. Policy/value/dynamics consumers keep stop-gradient
    # latents either way.
    ground_beliefs: bool = False

    # Dreamer-style actor-critic on the imagined rollout (experimental; no
    # reference counterpart). Policy maximizes imagined lambda-returns and
    # the value net regresses toward the same imagined returns, replacing
    # the EFE one-step pragmatic term and the replay-chained lambda targets
    # (see core.imagined_lambda_objective and DEVIATIONS.md).
    imagined_value_targets: bool = False
    # Actor entropy-bonus scale for imagined_value_targets (DreamerV2 uses
    # 1e-4..3e-4 for continuous control; reusing consistency_weight=0.1 lets
    # the entropy term dominate and pins log-std at its clamp).
    imagined_entropy_scale: float = 3e-4
    # EMA decay of the slow critic bootstrapping imagined lambda-returns
    # (Dreamer-style target network; only active with imagined_value_targets).
    target_value_decay: float = 0.98
    # Dreamer-v3 return normalization for the imagined actor: divide the
    # lambda-returns in the actor objective by max(1, S), where S is an EMA
    # of the per-batch 5th-95th percentile range of imagined returns. Keeps
    # the fixed entropy bonus at a constant relative scale and stops the
    # actor chasing exploding model-predicted returns (the observed
    # actor-exploits-model failure, DEVIATIONS.md). Only active with
    # imagined_value_targets.
    imagined_return_norm: bool = True
    return_norm_decay: float = 0.99
    # Slow-critic regularizer weight (Dreamer-v3): the critic loss adds
    # w * huber(V_live(z_im), sg(V_ema(z_im))) on the imagined states,
    # anchoring the live critic to its own EMA so actor and critic cannot
    # co-drift. Only active with imagined_value_targets.
    value_ema_regularizer: float = 1.0
    # SAC-style automatic entropy tuning for the imagined actor: learn the
    # entropy coefficient alpha (AgentTrainState.log_alpha) to hold policy
    # entropy at entropy_target (None -> -action_dim, the SAC heuristic).
    # Replaces the fixed imagined_entropy_scale. Addresses BOTH observed
    # failure directions: entropy growth into noise-dominated acting
    # (Pendulum, H -> +3.3) and entropy collapse into deterministic
    # model-exploitation (HalfCheetah, H -> -7.2). Imagined mode only.
    auto_entropy: bool = False
    entropy_target: Optional[float] = None
    alpha_lr: float = 3e-4
    # Actor learning-rate multiplier (policy group only). < 1 keeps the
    # actor behind the world model — the remaining drift lever after
    # return norm / auto-entropy / pessimism (see DEVIATIONS.md).
    policy_lr_scale: float = 1.0
    # Cosine-decay the actor learning rate from lr*policy_lr_scale down to
    # policy_lr_final_scale of that value over this many OPTIMIZER UPDATES
    # (None disables). Late-run eval oscillation on Hopper is behavioral
    # actor-dynamics co-adaptation at a fixed step size (DEVIATIONS.md drift
    # experiment A: ~175 plateau with +-50 swings while every training loss
    # stays healthy); annealing the actor converts that limit cycle into a
    # plateau, the classic actor-critic remedy. Policy group only — the
    # world model keeps learning at full rate.
    policy_lr_decay_steps: Optional[int] = None
    policy_lr_final_scale: float = 0.1
    # Late-run drift stabilizer (extension; DEVIATIONS.md forensics: every
    # env's eval peaks then decays as the actor slowly walks off the
    # world-model's support). Anchors the live actor to its own Polyak
    # average with w * mean KL(pi_live(.|z) || pi_ema(.|z)) in the actor
    # loss (KL of the pre-tanh Gaussians; tanh is a fixed bijection so the
    # squashed KL is identical). 0 disables. The EMA policy is maintained
    # whenever the weight > 0 or act_with_policy_ema is set.
    policy_anchor_weight: float = 0.0
    # Anchor warmup: the anchor KL is inactive until this many train steps
    # have run (hard gate on AgentTrainState.step, traced — no recompile).
    # Resolves the measured anchor tension: anchoring from init traps
    # from-scratch fused runs at the untrained policy (fused Ant3D run A:
    # eval -680 -> -1782 monotone worsening), while unanchored runs collapse
    # after their peak (Walker2d: +933 peak -> +10 final). With warmup the
    # run learns freely, then the anchor locks the plateau in — by the gate
    # step the Polyak average tracks the LEARNED policy (lag ~1/(1-decay)
    # updates), so the anchor target is the recent good policy, not init.
    policy_anchor_warmup_steps: int = 0
    policy_ema_decay: float = 0.995
    # Act/eval from the EMA policy instead of the live one (smooths the
    # eval curve; composes with use_ema_for_act which covers the score net).
    act_with_policy_ema: bool = False
    # Pessimism weight on imagined rewards: r_mean - w * r_std. The reward
    # head's std is NLL-calibrated on replay, so latents the actor pushes
    # out-of-distribution carry larger predicted std — penalizing them
    # counters model-error exploitation (MOPO-style, arXiv:2005.13239;
    # observed: imagined returns 11 -> 278 while real eval fell).
    imagined_reward_pessimism: float = 0.0
    # Dreamer-style continuation prediction: a small head c(z), trained by
    # BCE on replay dones, weights the imagined lambda-return bootstrap by
    # gamma * c(z_t). Without it imagination assumes infinite episodes —
    # correct for HalfCheetah (no termination), badly optimistic for
    # Hopper/Walker2d where falling terminates the episode (measured: both
    # plateau near random under the HalfCheetah preset while HalfCheetah
    # reaches +4486). The head always exists and trains; this flag gates
    # its use in imagination. Imagined-lambda mode only.
    predict_continuation: bool = False
    # Dynamics ensemble size (1 = the reference's single net). With K > 1
    # the "dynamics" param group holds K independently-initialized residual
    # MLPs (stacked pytree, vmapped apply); imagination samples a random
    # member per sample per step (TS1, MBPO arXiv:1906.08253), replay-side
    # training fits all members, and everything else (epistemic probes,
    # contrastive prediction) uses the ensemble mean.
    num_dynamics_ensemble: int = 1
    # Disagreement pessimism: subtract w * mean_dim(std over members of the
    # predicted next latent) from the imagined reward. Ensemble spread is
    # the canonical model-uncertainty signal where a single net's NLL std
    # extrapolates confidently (MOPO arXiv:2005.13239).
    ensemble_pessimism: float = 0.0
    # Hard clip on imagined rewards, in normalized-reward units (0 = off).
    # Replay rewards are normalized to ~N(0,1) before the reward head
    # trains, so any imagined reward beyond a few sigma is necessarily
    # model hallucination — MLPs extrapolate confidently, and the
    # NLL-sigma pessimism above cannot catch confident extrapolation
    # (measured: imagined per-step rewards ~22 normalized units while real
    # collected rewards stayed ~N(0,1)). 5.0 is a generous bound.
    imagined_reward_clip: float = 0.0
    # Fixed next-latent log-variance of the learned dynamics (the reference
    # hardcodes log(0.1), core/active_inference.py:463 — an arbitrary,
    # untrained constant). sigma~0.32/dim compounds over the imagination
    # horizon and puts a variance floor under the critic's lambda-targets.
    dynamics_logvar: float = -2.3025850929940455  # log(0.1), reference value
    # Roll imagination (EFE and imagined-lambda) on the dynamics MEAN instead
    # of sampling the fixed-variance noise — removes the arbitrary-noise
    # variance floor from policy/value targets. Replay-side dynamics training
    # and the epistemic estimator are unaffected.
    imagine_deterministic: bool = False

    # Posterior-grounded beliefs (experimental; no reference counterpart).
    # The reference's score-matching target is the sweep's own (no_grad)
    # output — self-referential: the sweep distribution is trained toward its
    # own samples and nothing grounds belief latents to observations
    # (reference agents/state_agent.py:134-140; see DEVIATIONS.md). With this
    # flag an amortized Gaussian posterior q(z|o) (trained in the model group
    # by reconstruction + reward NLL + KL) supplies the training latents, and
    # the score network learns to SAMPLE q(z|o) — the reverse sweep becomes an
    # iterative approximation of a grounded posterior. Dynamics/policy/value
    # consume (stop-gradient) posterior samples.
    posterior_beliefs: bool = False
    # Act from the posterior head instead of running the reverse sweep at
    # act time (requires posterior_beliefs; cheaper collection, no
    # train/act distribution mismatch). The sweep remains available for
    # beliefs-by-diffusion acting either way.
    act_from_posterior: bool = False

    # Deterministic belief sweeps (experimental): run the reverse diffusion
    # without injected noise so the belief is a deterministic function of the
    # observation (the posterior-mean analogue). Addresses the architectural
    # mismatch documented in DEVIATIONS.md: stochastic sampled beliefs feed a
    # deterministic latent dynamics model, so every downstream consumer
    # (dynamics, reward, value, policy) sees a different latent for the same
    # observation. Applies to training sweeps and acting.
    deterministic_beliefs: bool = False

    # Training
    batch_size: int = 256
    learning_rate: float = 5e-5
    gradient_clip: float = 0.5
    # Reference-schema compat, inert in the reference too (its score group is
    # clipped with the same global gradient_clip as every other group,
    # reference agents/state_agent.py:151-158).
    score_gradient_clip: float = 0.1
    ema_decay: float = 0.9999
    # Act/eval with the EMA shadow of the score network (standard diffusion
    # practice). The reference maintains the EMA but never applies it
    # (agents/base_agent.py:73-77; shadow weights unused at act time).
    use_ema_for_act: bool = False
    epistemic_update_every: int = 5

    # Reward-oriented active inference. preference_temperature initializes
    # the train-state scalar the EFE pragmatic term divides by (reference
    # core/active_inference.py:68-70, 353). The remaining knobs are
    # reference-schema compat and inert in the reference too — it declares a
    # temperature adaptation scheme it never implements (zero reads outside
    # its configs/config.py), so the temperature stays at its init there and
    # here.
    preference_temperature: float = 1.0
    preference_learning_rate: float = 0.01
    min_preference_temperature: float = 0.1
    max_preference_temperature: float = 10.0
    temperature_decay: float = 0.995
    use_reward_preferences: bool = True
    baseline_reward: float = 0.0
    preference_momentum: float = 0.9

    # Nested configs
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    belief_dynamics: BeliefDynamicsConfig = field(default_factory=BeliefDynamicsConfig)
    semantics: SemanticsConfig = field(default_factory=SemanticsConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    # Accepted for schema compatibility with the reference; device placement is
    # managed by JAX (jax.devices()), not this field.
    device: str = "tpu"

    def __post_init__(self):
        # Reference-schema aliases: the reference declares BOTH names and
        # reads neither; here the short name is the real knob, and setting
        # only the long/legacy name folds into it instead of being silently
        # ignored. Setting both to different non-defaults is ambiguous.
        if self.expected_free_energy_horizon != 5:
            if self.efe_horizon not in (5, self.expected_free_energy_horizon):
                raise ValueError(
                    "expected_free_energy_horizon and efe_horizon are "
                    "aliases; set one"
                )
            self.efe_horizon = self.expected_free_energy_horizon
        self.expected_free_energy_horizon = self.efe_horizon
        if self.extrinsic_weight != 1.0:
            if self.pragmatic_weight not in (1.0, self.extrinsic_weight):
                raise ValueError(
                    "extrinsic_weight and pragmatic_weight are aliases; "
                    "set one"
                )
            self.pragmatic_weight = self.extrinsic_weight
        self.extrinsic_weight = self.pragmatic_weight


@dataclass
class PixelObservationConfig:
    """Pixel observation configuration (reference: configs/config.py:88-97)."""

    image_shape: Tuple[int, int, int] = (3, 84, 84)
    frame_stack: int = 3
    encoder_type: str = "drqv2"  # drqv2 | state | multiview
    encoder_feature_dim: int = 80
    augmentation: bool = True
    random_shift_pad: int = 4
    pixel_observation: bool = True


@dataclass
class TrainingConfig:
    """Training loop configuration (reference: configs/config.py:100-126)."""

    total_timesteps: int = 1_000_000
    eval_frequency: int = 5_000
    save_frequency: int = 50_000
    log_frequency: int = 1_000

    exploration_noise: float = 0.1
    exploration_decay: float = 0.999
    min_exploration: float = 0.01

    buffer_size: int = 100_000
    learning_starts: int = 5_000
    train_frequency: int = 2
    gradient_steps: int = 4
    # Cap on the number of updates fused into ONE train_epoch scan dispatch.
    # gradient_steps * collected can reach 1000+ updates per block; for pixel
    # agents that is a multi-minute single device execution, which the remote
    # TPU worker kills mid-run ("TPU worker process crashed or restarted",
    # observed twice at the first pixel training block). 0 disables chunking.
    epoch_chunk_updates: int = 256
    num_parallel_envs: int = 6
    num_eval_episodes: int = 10
    # Reverse-diffusion steps used at collection time (reference entry point
    # passes 20 on a 25-step schedule, examples/train_mujoco.py:221); None
    # runs the full schedule.
    collect_diffusion_steps: Optional[int] = None
    # Warm-start partial denoising at collect time: each env's belief latent
    # seeds the next control step's (truncated) sweep instead of pure noise
    # (cf. Falcon, arXiv:2503.00339); episode ends reset to fresh noise.
    # Default off = reference behavior (full re-noise every step,
    # utils/async_collector.py:530-595).
    collect_warm_start: bool = False

    use_wandb: bool = False
    project_name: str = "active-inference-diffusion-tpu"
    experiment_name: Optional[str] = None
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    resume: Optional[str] = None


def _update_dataclass(obj: Any, data: Dict[str, Any]) -> Any:
    """Recursively update a dataclass instance from a nested dict.

    Re-runs ``__post_init__`` after the updates so YAML-loaded configs get
    the same validation and alias folding as constructor arguments
    (prediction_type/use_continuous_time/semantics-mode checks, the
    expected_free_energy_horizon/extrinsic_weight aliases) — setattr alone
    would silently bypass all of it."""
    for key, value in data.items():
        if not hasattr(obj, key):
            raise KeyError(
                f"Unknown config field '{key}' for {type(obj).__name__}"
            )
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value)
        elif isinstance(current, tuple) and isinstance(value, list):
            setattr(obj, key, tuple(value))
        else:
            setattr(obj, key, value)
    post = getattr(obj, "__post_init__", None)
    if post is not None:
        post()
    return obj


def config_to_dict(obj: Any) -> Any:
    """Convert a (possibly nested) config dataclass to plain dicts for logging."""
    if dataclasses.is_dataclass(obj):
        return {
            f.name: config_to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    return obj


def load_yaml_config(
    path: str,
) -> Tuple[ActiveInferenceConfig, TrainingConfig, Optional[PixelObservationConfig]]:
    """Load configs from a YAML file.

    Closes a capability gap in the reference: YAML files exist in the reference's
    examples/configs/ but are never loaded by any code path (reference:
    examples/train_mujoco.py:443-456 has no --config flag). Schema uses the same
    section names: ``active_inference:``, ``pixel:``, ``training:``.
    PyYAML is imported here, not with the module: a GPU host may lack it.
    """
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}

    ai_config = ActiveInferenceConfig()
    training_config = TrainingConfig()
    pixel_config: Optional[PixelObservationConfig] = None

    if "active_inference" in data:
        _update_dataclass(ai_config, data["active_inference"])
    if "diffusion" in data:  # allow top-level diffusion section too
        _update_dataclass(ai_config.diffusion, data["diffusion"])
    if "training" in data:
        _update_dataclass(training_config, data["training"])
    if "pixel" in data:
        pixel_config = PixelObservationConfig()
        _update_dataclass(pixel_config, data["pixel"])
        ai_config.pixel_observation = pixel_config.pixel_observation

    return ai_config, training_config, pixel_config
